"""Device ms a rollout step charged to the program's `gfvgn.fv.residual`
span, over the second profiled stretch of `run.py --trace 1`.
"""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "rollout", "gfvgn.fv.residual")
