"""Mean host ms of the program's `gfvgn.rollout.step` span (the step's call,
to its return, no synchronize inside) over the third stretch of
`run.py --trace 1`: one whole request, unprofiled.
"""

from benchmark.harness.spans import span_host_ms


def read(run):
    return span_host_ms(run, "rollout", "gfvgn.rollout.step")
