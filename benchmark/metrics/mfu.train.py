"""The train step's model operations (benchmark/harness/flops.py) over its
wall time on the traced run's unprofiled stretch times the H100's 989
TFLOP/s bf16 peak, %.
"""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, "train")
