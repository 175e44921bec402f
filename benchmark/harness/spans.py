"""From the program's own spans (`gen_fvgn_tpu_torch/utils/spans.py`) to
per-layer numbers.

Three sources, each one stretch of a traced run (`run.py --trace 1`):

* set-up, the spans on: seconds in `gfvgn.setup.envs`;
* the second profiled stretch (host and device activities), the spans on:
  every kernel, copy or fill is charged to a program span (`attribute`),
  and the longest idle gaps are named by the host operation and the
  program span over them (`name_gaps`);
* a third stretch, unprofiled, the spans on: host ms a step by span name.

`attribute`: a device operation is linked by its correlation id to the
runtime call that launched it; the call goes to the innermost program span
open on its thread at that time; where none is open on that thread (the
autograd engine's thread during a backward), to the innermost span open
then on the thread that holds the outermost open program span (the one
that opened `gfvgn.train.step`); anything else is `UNATTRIBUTED`.
"""

from __future__ import annotations

import json
import re
import statistics
from typing import Dict, List, Optional, Tuple

from benchmark.harness import flops
from benchmark.harness import trace as tr

PREFIX = "gfvgn."
UNATTRIBUTED = "unattributed"
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "copy",
                "gpu_memset": "fill"}
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
RUNTIME_NAME = re.compile(r"^cu(da)?[A-Z]")     # cudaLaunchKernel, cuMemcpy

# (start_ns, end_ns, name, correlation id, kind: kernel / copy / fill)
Op = Tuple[int, int, str, int, str]
# (name, start_ns, end_ns, thread)
Mark = Tuple[str, int, int, int]


def _kind(e, host_marks) -> str:
    """The event's activity type; where the profiler's events lack it
    (older torch), told from the device, the annotation flag and the name
    as `trace._device_ops` tells them."""
    try:
        return e.activity_type()
    except AttributeError:
        pass
    name = e.name()
    if tr._on_device(e):
        if tr._annotation(e) or name in host_marks:
            return "gpu_user_annotation"
        low = name.lower()
        return ("gpu_memcpy" if low.startswith("memcpy") else
                "gpu_memset" if low.startswith("memset") else "kernel")
    if tr._annotation(e):
        return "user_annotation"
    return "cuda_runtime" if RUNTIME_NAME.match(name) else "cpu_op"


def from_kineto(evs) -> Tuple[List[Op], Dict[int, Tuple[int, int]],
                              List[Mark]]:
    """(device operations, {correlation id: (start, thread) of the runtime
    call}, the program's spans as the profiler recorded them) of a list of
    kineto events."""
    evs = list(evs)
    host_marks = {e.name() for e in evs
                  if not tr._on_device(e) and tr._annotation(e)}
    ops, calls, marks = [], {}, []
    for e in evs:
        kind = _kind(e, host_marks)
        if kind in DEVICE_KINDS and e.duration_ns() > 0:
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name(), e.correlation_id(), DEVICE_KINDS[kind]))
        elif kind in RUNTIME_KINDS:
            calls[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind == "user_annotation" and e.name().startswith(PREFIX):
            marks.append((e.name(), e.start_ns(),
                          e.start_ns() + e.duration_ns(),
                          e.start_thread_id()))
    return ops, calls, marks


def _innermost(marks: List[Mark], t: int, thread=None) -> Optional[Mark]:
    open_ = [m for m in marks if m[1] <= t <= m[2]
             and (thread is None or m[3] == thread)]
    return max(open_, key=lambda m: (m[1], -m[2])) if open_ else None


def owner(marks: List[Mark], t: int, thread: int) -> str:
    """The program span charged with a runtime call at `t` on `thread`."""
    m = _innermost(marks, t, thread)
    if m is None:
        outer = [m for m in marks if m[1] <= t <= m[2]]
        if outer:
            top = min(outer, key=lambda m: (m[1], -m[2]))
            m = _innermost(marks, t, top[3])
    return m[0] if m is not None else UNATTRIBUTED


def attribute(ops: List[Op], calls: Dict[int, Tuple[int, int]],
              marks: List[Mark]) -> Dict:
    """Device ns by program span (`ns`), of them in copies (`copy_ns`), by
    (span, operation name) (`by_op`), and the total."""
    ns: Dict[str, int] = {}
    copy_ns: Dict[str, int] = {}
    by_op: Dict[Tuple[str, str], int] = {}
    for a, b, op, corr, kind in ops:
        call = calls.get(corr)
        name = owner(marks, *call) if call is not None else UNATTRIBUTED
        ns[name] = ns.get(name, 0) + (b - a)
        by_op[name, op] = by_op.get((name, op), 0) + (b - a)
        if kind == "copy":
            copy_ns[name] = copy_ns.get(name, 0) + (b - a)
    return {"ns": ns, "copy_ns": copy_ns, "by_op": by_op,
            "total_ns": sum(b - a for a, b, *_ in ops)}


def name_gaps(evs, top: int = 10) -> List[List]:
    """The `top` longest gaps with no device operation inside the stretch
    that `trace.STRETCH` marks: [host operation over the gap's middle (as
    `trace.idle_gaps` names it), innermost program span over it or
    "(no program span)", seconds]."""
    evs = list(evs)
    stretch = [e for e in evs if e.name() == tr.STRETCH
               and not tr._on_device(e)]
    if not stretch:
        return []
    lo = stretch[0].start_ns()
    hi = lo + stretch[0].duration_ns()
    merged = tr._merge([op for op in tr._device_ops(evs)
                        if op[1] > lo and op[0] < hi])
    gaps, prev = [], lo
    for a, b in merged + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in evs if not tr._on_device(e) and e.name() != tr.STRETCH
            and e.start_ns() <= hi and e.start_ns() + e.duration_ns() >= lo]
    marks = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id()) for e in host
             if e.name().startswith(PREFIX)]
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        inner = [e for e in host
                 if e.start_ns() <= mid <= e.start_ns() + e.duration_ns()]
        op = max(inner, key=lambda e: e.start_ns()).name() if inner \
            else "(no host operation)"
        m = _innermost(marks, mid)
        out.append([op[:160], m[0] if m else "(no program span)",
                    (b - a) * 1e-9])
    return out


# ------------------------------------------------ the run record's part

def host_summary(recorded, steps: int, seconds: float) -> Dict:
    """The third stretch: mean host ms of each span name, the spans a
    step, wall ms a step."""
    by: Dict[str, List[float]] = {}
    for s in recorded:
        by.setdefault(s.name, []).append((s.end_ns - s.start_ns) * 1e-6)
    return {"steps": steps, "wall_ms": 1e3 * seconds / steps,
            "ms": {k: statistics.fmean(v) for k, v in by.items()},
            "spans_per_step": len(recorded) / steps}


def device_summary(att: Dict, recorded) -> Dict:
    """The second stretch: device ms a step by span (steps: its
    `gfvgn.train.step` or `gfvgn.rollout.step` spans), the copies' ms a
    step by span, the 10 (span, operation) pairs that take most, the
    record's bytes a step and the share of device time charged to no
    span."""
    steps = sum(s.name in ("gfvgn.train.step", "gfvgn.rollout.step")
                for s in recorded)
    if not steps or not att["total_ns"]:
        return {}
    rec = [s.attrs.get("bytes", 0) for s in recorded
           if s.name == "gfvgn.rollout.record"]
    top = sorted(att["by_op"].items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps,
            "ms": {k: v * 1e-6 / steps for k, v in att["ns"].items()},
            "top": [[where, op[:120], v * 1e-6 / steps]
                    for (where, op), v in top],
            "copy_ms": {k: v * 1e-6 / steps
                        for k, v in att["copy_ns"].items()},
            "record_bytes": sum(rec) / steps,
            "unattributed": att["ns"].get(UNATTRIBUTED, 0)
            / att["total_ns"]}


def program_record(got: Dict) -> Dict:
    """The run record's `program` from what a traced run gathered:
    `setup` (set-up's spans), `attribution` and `gaps` (`attribute`,
    `name_gaps`) with `profiled` (the second stretch's spans), `third`
    (the third stretches: steps, wall seconds with the spans on (True) and
    off (False), the spans)."""
    envs = [s.seconds for s in got["setup"] if s.name == "gfvgn.setup.envs"]
    prog = {"setup": {"envs_s": sum(envs) if envs else None}}
    if "attribution" in got and got.get("profiled"):
        prog["device"] = device_summary(got["attribution"], got["profiled"])
        prog["gaps"] = got["gaps"]
    if "third" in got:
        third = got["third"]
        steps = third["steps"] * len(third[True])
        prog["host"] = host_summary(third["spans"], steps, sum(third[True]))
        prog["host"]["off_wall_ms"] = 1e3 * sum(third[False]) / steps
    return prog


def detail_lines(prog: Dict, mode: str, window: Dict) -> List[str]:
    """Standard error's lines of the spans: device ms by span and the
    share charged to none, the operations that take most by span, the idle
    gaps by span, the third stretches with the spans on against off, a
    rollout step's host + record + export against its wall time."""
    lines = []
    dev, host = prog.get("device"), prog.get("host")
    if dev:
        lines.append(f"detail spans: device ms a step by span "
                     f"{json.dumps(dev['ms'], sort_keys=True)}; "
                     f"unattributed share {dev['unattributed']!r}")
        lines += [f"detail spans: {ms!r} ms a step in {where}: {op}"
                  for where, op, ms in dev["top"]]
        for op, where, s in prog["gaps"]:
            lines.append(f"detail spans: idle gap {1e3 * s!r} ms in "
                         f"{where} under {op}")
    if host:
        win_ms = (1e3 * window["seconds"] / window["steps"]
                  if window and window["steps"] else None)
        lines.append(f"detail spans: third stretches {host['wall_ms']!r} ms "
                     f"a step with {host['spans_per_step']!r} spans a step "
                     f"on, {host['off_wall_ms']!r} off (on / off - 1 = "
                     f"{host['wall_ms'] / host['off_wall_ms'] - 1:+.4%}); "
                     f"window {win_ms!r} ms a step, spans off")
        if mode == "rollout":
            ms = host["ms"]
            parts = sum(ms.get(f"gfvgn.rollout.{k}", 0.0)
                        for k in ("step", "record", "export"))
            lines.append(f"detail spans: host + record + export {parts!r} "
                         f"ms against {host['wall_ms']!r} ms a step")
    return lines


# ------------------------------------------------------------- readers

def _program(run, mode: Optional[str], part: str) -> Optional[Dict]:
    if (mode is not None and run["mode"] != mode) or not run["trace"]:
        return None
    return (run.get("program") or {}).get(part) or None


def device_ms(run, mode: str, name: str) -> Optional[float]:
    """Device ms a step charged to span `name` (second stretch)."""
    dev = _program(run, mode, "device")
    return dev["ms"].get(name) if dev else None


def span_roofline(run, mode: str, name: str, part: str) -> Optional[float]:
    """The least time of the forward's model operations whose names hold
    `part` (`flops.bound_seconds`) over the device ms a step charged to
    span `name`, %. None where no such operation or no device time."""
    ms = device_ms(run, mode, name)
    ops = [o for o in run.get("ops") or []
           if part in o.name and not o.name.endswith(".backward")]
    if not ms or not ops:
        return None
    return 100.0 * flops.bound_seconds(ops) / (ms * 1e-3)


def span_host_ms(run, mode: str, name: str) -> Optional[float]:
    """Mean host ms of span `name` over the third stretch."""
    host = _program(run, mode, "host")
    return host["ms"].get(name) if host else None


def record_gbps(run) -> Optional[float]:
    """The record's bytes over the device time of the copies charged to
    `gfvgn.rollout.record`, GB/s."""
    dev = _program(run, "rollout", "device")
    ms = dev["copy_ms"].get("gfvgn.rollout.record") if dev else None
    if not ms or not dev["record_bytes"]:
        return None
    return dev["record_bytes"] / (ms * 1e-3) * 1e-9


def envs_s(run) -> Optional[float]:
    """Seconds in `gfvgn.setup.envs` during set-up."""
    setup = _program(run, None, "setup")
    return setup.get("envs_s") if setup else None
