"""Seconds in the program's `gfvgn.setup.envs` span during set-up: the
pool's environments padded and stacked on the device (part of
`statics_s`).
"""

from benchmark.harness.spans import envs_s


def read(run):
    return envs_s(run)
