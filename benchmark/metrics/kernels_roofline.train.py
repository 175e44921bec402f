"""The train step's least time (each model operation at the larger of its
operations over its peak and its bytes over 3.35 TB/s) over its device-
busy time in the profiled stretch, %.
"""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "train")
