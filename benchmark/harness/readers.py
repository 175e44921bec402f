"""What the metric files read from a run's record.

A run record (`run.py`) holds: mode ("train" or "rollout"), trace, the
set-up and statics seconds, the window (steps, seconds, each step's
latency; a train step call's host seconds), the profiled stretch's summary
(`trace.reduce_device`: busy and wall seconds, kernels a step, the top
operations, `ops_s`: every device operation's seconds a step by name) and
its steps, the step's model operations by name (`flops`), and with
`--trace 1` the program's spans (`program`: `spans.program_record`).
Every reader returns None where its cell has nothing for it to read.
"""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark.harness import flops


def step_ms(run, mode: str) -> Optional[float]:
    w = run["window"]
    if run["mode"] != mode or run["trace"] or not w["steps"]:
        return None
    return 1e3 * w["seconds"] / w["steps"]


def p95_ms(run, mode: str) -> Optional[float]:
    lat = run["window"].get("latencies") or []
    if run["mode"] != mode or run["trace"] or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]


def host_ms(run, mode: str) -> Optional[float]:
    spans = run["window"].get("spans") or []
    if run["mode"] != mode or not run["trace"] or not spans:
        return None
    return 1e3 * statistics.fmean(spans)


def launches(run, mode: str) -> Optional[float]:
    p = run["profile"]
    if run["mode"] != mode or not p.get("busy_s"):
        return None
    return p["kernels_per_step"]


def mfu(run, mode: str) -> Optional[float]:
    w = run["window"]
    if run["mode"] != mode or not run["trace"] or not w["steps"]:
        return None
    step_s = w["seconds"] / w["steps"]
    return 100.0 * flops.total_flops(run["ops"]) / (step_s * flops.PEAK_BF16)


def roofline(run, mode: str) -> Optional[float]:
    p = run["profile"]
    if run["mode"] != mode or not p.get("busy_s"):
        return None
    busy_step = p["busy_s"] / run["profile_steps"]
    return 100.0 * flops.bound_seconds(run["ops"]) / busy_step


def idle(run, mode: str) -> Optional[float]:
    p = run["profile"]
    if run["mode"] != mode or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
