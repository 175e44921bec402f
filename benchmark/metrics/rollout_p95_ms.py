"""95th percentile of the latency of every rollout step in the window, each
from the end of the step before (or the request's start) to its record
on the host, ms.
"""

from benchmark.harness.readers import p95_ms


def read(run):
    return p95_ms(run, "rollout")
