"""The Transolver blocks' least time in a train step's forward (their
forward model operations alone, `*.transolver.*` in
benchmark/harness/flops.py: the span covers no backward) over the device
ms a step charged to the program's `gfvgn.model.attention` span in the
second profiled stretch, %.
"""

from benchmark.harness.spans import span_roofline


def read(run):
    return span_roofline(run, "train", "gfvgn.model.attention",
                         ".transolver.")
