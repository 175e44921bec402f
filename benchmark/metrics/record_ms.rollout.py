"""Mean host ms of the program's `gfvgn.rollout.record` span (the record's
copies to the host, which wait for the step's kernels) over the third
stretch of `run.py --trace 1`: one whole request, unprofiled.
"""

from benchmark.harness.spans import span_host_ms


def read(run):
    return span_host_ms(run, "rollout", "gfvgn.rollout.record")
