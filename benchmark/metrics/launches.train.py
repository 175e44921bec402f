"""Device kernels a train step, counted by torch.profiler over the profiled
stretch.
"""

from benchmark.harness.readers import launches


def read(run):
    return launches(run, "train")
