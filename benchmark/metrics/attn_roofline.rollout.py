"""The Transolver blocks' least time in a rollout step (their forward
model operations, `*.transolver.*` in benchmark/harness/flops.py, each at
the larger of its operations over its peak and its bytes over 3.35 TB/s)
over the device ms a step charged to the program's `gfvgn.model.attention`
span (the whole block: attention and pre-LayerNorm MLP) in the second
profiled stretch, %; none for a net without them.
"""

from benchmark.harness.spans import span_roofline


def read(run):
    return span_roofline(run, "rollout", "gfvgn.model.attention",
                         ".transolver.")
