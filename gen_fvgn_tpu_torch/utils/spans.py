"""Spans at the port's own layer boundaries, off unless turned on.

    from gen_fvgn_tpu_torch.utils import spans
    spans.enable(True)
    ...                          # the program runs and records its spans
    recorded = spans.take()      # [Span]; the record is cleared
    spans.enable(False)

`span(name, **attrs)` is a context manager. Off (the default) it checks one
module global and returns a shared `contextlib.nullcontext()`. On, it
records a `Span`: its name, its start and end in ns on the profiler's
clock, the index in the record of the span open on the same thread when it
opened (its parent; -1 for none), and its attributes: counts such as
`bytes=` or `n=` (`note` adds some to the innermost open span of the
thread). While a `torch.profiler` profile runs, an open span also opens
`torch.profiler.record_function(name)`, so that it lies on the profiler's
host timeline beside the kernels and copies launched inside it.

The times are `time.perf_counter_ns()` plus one offset, taken in `enable`,
to `time.time_ns()`: the clock of the profiler's host events, Unix-epoch
ns (`tests/test_torch_spans.py` holds the two together).

The program's spans, each read by the benchmark (PERF.md §3):
`gfvgn.setup.envs` (n), `gfvgn.pool.gather` (n), `gfvgn.pool.payback` (n),
`gfvgn.train.step` (step), `gfvgn.fv.residual`, `gfvgn.model.attention`,
`gfvgn.train.backward`, `gfvgn.train.optimizer`, `gfvgn.rollout.request`
(steps), `gfvgn.rollout.step` (t), `gfvgn.rollout.record` (t, bytes),
`gfvgn.rollout.export` (t).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

_ON = False
_NULL = contextlib.nullcontext()
_OFFSET_NS = 0
_RECORD: List["Span"] = []
_LOCK = threading.Lock()
_LOCAL = threading.local()


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int = -1             # -1 while open
    parent: int = -1             # index in the same record; -1 for none
    attrs: Dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def enabled() -> bool:
    return _ON


def enable(flag: bool = True) -> None:
    """Turn recording on or off; turning it on takes the clock's offset."""
    global _ON, _OFFSET_NS
    if flag and not _ON:
        _OFFSET_NS = time.time_ns() - time.perf_counter_ns()
    _ON = bool(flag)


def take() -> List[Span]:
    """The spans recorded since the last `take`, in the order they opened;
    the record is cleared. A span still open ends in the list returned."""
    global _RECORD
    with _LOCK:
        out, _RECORD = _RECORD, []
    return out


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Open:
    __slots__ = ("name", "attrs", "rf")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs, self.rf = name, attrs, None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        st = _stack()
        s = Span(self.name, time.perf_counter_ns() + _OFFSET_NS,
                 attrs=self.attrs)
        with _LOCK:
            rec = _RECORD
            if st and st[-1][1] is rec:
                s.parent = st[-1][2]
            st.append((s, rec, len(rec)))
            rec.append(s)
        return s

    def __exit__(self, *exc):
        s, _, _ = _stack().pop()
        s.end_ns = time.perf_counter_ns() + _OFFSET_NS
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around one span of the program (the module's
    docstring)."""
    if not _ON:
        return _NULL
    return _Open(name, attrs)


def note(**attrs) -> None:
    """Add `attrs` to the innermost span open on this thread (nothing where
    recording is off or no span is open)."""
    if not _ON:
        return
    st = _stack()
    if st:
        st[-1][0].attrs.update(attrs)
