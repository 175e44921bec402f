"""Device ms a train step charged to the program's `gfvgn.model.attention`
span (the Transolver blocks' forward), over the second profiled stretch of
`run.py --trace 1`.
"""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "train", "gfvgn.model.attention")
