"""The window's wall time over the rollout steps completed in it, ms (host
clock; the window ends in a synchronize or a record on the host).
"""

from benchmark.harness.readers import step_ms


def read(run):
    return step_ms(run, "rollout")
