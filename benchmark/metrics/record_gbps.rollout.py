"""The rollout record's bytes a step over the device time of the copies
charged to the program's `gfvgn.rollout.record` span, GB/s, over the second
profiled stretch of `run.py --trace 1`.
"""

from benchmark.harness.spans import record_gbps


def read(run):
    return record_gbps(run)
