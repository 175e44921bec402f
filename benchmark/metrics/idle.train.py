"""Share of the profiled stretch's wall time in which no operation ran on
the device (torch.profiler; busy and wall from the same stretch), %.
"""

from benchmark.harness.readers import idle


def read(run):
    return idle(run, "train")
