"""Mean host time of one train step call, from call to return, no
synchronize inside, over the traced run's unprofiled stretch, ms.
"""

from benchmark.harness.readers import host_ms


def read(run):
    return host_ms(run, "train")
