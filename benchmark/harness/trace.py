"""From `torch.profiler` traces of stretches of steps to the device's busy
time, its idle share, the kernels a step and the breakdown.

Two stretches, each opened and closed by a synchronize. The first is
traced on the device only (CUPTI's activity records, no host operation
recorded, so the host runs nearly as it does untraced): its busy time is
the union of the intervals in which a kernel, copy or fill ran, its wall
time the host clock around it, so both come from the same interval. The
second, shorter, also records the host's operations, which slows the
host; it only names what the host was doing in the longest idle gaps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

STRETCH = "benchmark.profiled_stretch"


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type()) or "GPU" in str(e.device_type())


def _annotation(e) -> bool:
    try:
        return bool(e.is_user_annotation())
    except AttributeError:
        return False


def _device_ops(evs) -> List[Tuple[int, int, str]]:
    """(start, end, name) of the kernels, copies and fills on the device.
    Left out: the host's annotations that the profiler mirrors onto the
    device's timeline (flagged as such, named as a host annotation, or a
    range that holds another device operation: kernels do not nest)."""
    marks = {e.name() for e in evs if not _on_device(e) and _annotation(e)}
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in evs if _on_device(e) and not _annotation(e)
                 and e.name() not in marks and e.duration_ns() > 0)
    out = []
    for i, (a, b, name) in enumerate(ops):
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if nxt is not None and nxt[0] >= a and nxt[1] <= b:
            continue
        out.append((a, b, name))
    return out


def _merge(ops) -> List[List[int]]:
    merged: List[List[int]] = []
    for a, b, _ in ops:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_device(prof, steps: int, wall_s: float) -> Dict:
    """Busy seconds, the stretch's wall seconds, kernels a step, the 10
    device operations that took most time, by name, and every operation's
    device seconds a step by its full name (`ops_s`)."""
    ops = _device_ops(list(prof.profiler.kineto_results.events()))
    if not ops:
        return {}
    busy = sum(b - a for a, b in _merge(ops))
    by_name: Dict[str, int] = {}
    for a, b, name in ops:
        by_name[name] = by_name.get(name, 0) + (b - a)
    kernels = sum(not n.lower().startswith(("memcpy", "memset"))
                  for _, _, n in ops)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": wall_s, "busy_s": busy * 1e-9,
            "kernels_per_step": kernels / steps,
            "device_ops": [[k[:160], v * 1e-9] for k, v in top],
            "ops_s": {k: v * 1e-9 / steps for k, v in by_name.items()}}


def idle_gaps(prof) -> List[List]:
    """The 10 longest gaps with no device operation inside the annotated
    stretch, each named by the innermost host operation spanning its
    middle."""
    evs = list(prof.profiler.kineto_results.events())
    marks = [e for e in evs if e.name() == STRETCH and not _on_device(e)]
    if not marks:
        return []
    lo = marks[0].start_ns()
    hi = lo + marks[0].duration_ns()
    merged = _merge([op for op in _device_ops(evs)
                     if op[1] > lo and op[0] < hi])
    gaps, prev = [], lo
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in evs if not _on_device(e) and e.name() != STRETCH
            and e.start_ns() <= hi and e.start_ns() + e.duration_ns() >= lo]
    out = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        inner = [e for e in host
                 if e.start_ns() <= mid <= e.start_ns() + e.duration_ns()]
        name = max(inner, key=lambda e: e.start_ns()).name() if inner \
            else "(no host operation)"
        out.append([name[:160], (b - a) * 1e-9])
    return out
