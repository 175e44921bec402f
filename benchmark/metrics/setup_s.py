"""Set-up: process start until the first timed step, seconds (host clock)."""

def read(run):
    return run["setup_s"]
