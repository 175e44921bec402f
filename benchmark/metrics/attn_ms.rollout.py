"""Device ms a rollout step charged to the program's `gfvgn.model.attention`
span (the Transolver blocks), over the second profiled stretch of
`run.py --trace 1`; none for a net without them.
"""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "rollout", "gfvgn.model.attention")
