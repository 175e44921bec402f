"""Device ms a train step charged to the program's `gfvgn.fv.residual` span
(the FV residual's forward; its backward is in `backward_ms.train`), over
the second profiled stretch of `run.py --trace 1`.
"""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "train", "gfvgn.fv.residual")
