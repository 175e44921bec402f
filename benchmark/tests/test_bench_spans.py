"""The reading of the program's spans (`harness/spans.py`, `run.py
--trace 1`, the readers of the per-layer metrics that read them) and of
the device trace (`harness/trace.py`): attribution of device time on
synthetic event lists, every operation's time in the record, each
reader's None where it has nothing to read, and whole runs of a cut-down
cell on the CPU, traced and not."""

import pytest

from benchmark import run
from benchmark.harness import cells, flops
from benchmark.harness import spans as hs
from benchmark.harness import spec
from benchmark.harness import trace as tr
from benchmark.tests.bench_common import tiny_cell

# the per-layer metrics read from the program's spans
SPAN_METRICS = ("fv_ms.train", "fv_ms.rollout", "attn_ms.train",
                "attn_ms.rollout", "backward_ms.train", "optimizer_ms.train",
                "host_ms.rollout", "record_ms.rollout", "record_gbps.rollout",
                "envs_s", "attn_roofline.train", "attn_roofline.rollout")


def span_metrics():
    return [m for m in spec.benchmark_file()["per_layer"]
            if m["name"] in SPAN_METRICS]

MAIN, AUTOGRAD = 1, 2
MARKS = [("gfvgn.train.step", 100, 1000, MAIN),
         ("gfvgn.fv.residual", 200, 300, MAIN),
         ("gfvgn.train.backward", 400, 700, MAIN),
         ("gfvgn.train.optimizer", 800, 900, MAIN),
         ("gfvgn.rollout.request", 2000, 3000, MAIN),
         ("gfvgn.rollout.step", 2100, 2400, MAIN),
         ("gfvgn.rollout.record", 2500, 2800, MAIN)]


def _attribute(calls):
    """One kernel of 10 ns a launch, ids 1, 2, ...; a copy where the
    launch names one."""
    ops, table = [], {}
    for i, (t, thread, kind) in enumerate(calls, 1):
        ops.append((5000 + 20 * i, 5010 + 20 * i, f"k{i}", i, kind))
        table[i] = (t, thread)
    return hs.attribute(ops, table, MARKS)


@pytest.mark.parametrize("t, thread, span", [
    (150, MAIN, "gfvgn.train.step"),          # in the step, outside the rest
    (250, MAIN, "gfvgn.fv.residual"),         # nested
    (500, AUTOGRAD, "gfvgn.train.backward"),  # the autograd engine's thread
    (850, MAIN, "gfvgn.train.optimizer"),
    (2200, MAIN, "gfvgn.rollout.step"),
    (2450, MAIN, "gfvgn.rollout.request"),    # between the step and record
    (50, MAIN, hs.UNATTRIBUTED),              # before every span
    (1500, AUTOGRAD, hs.UNATTRIBUTED),        # another thread, no span open
])
def test_a_launch_goes_to_the_innermost_span(t, thread, span):
    att = _attribute([(t, thread, "kernel")])
    assert att["ns"] == {span: 10} and att["total_ns"] == 10


def test_a_copy_in_the_record_and_a_kernel_without_its_launch():
    att = _attribute([(2600, MAIN, "copy"), (2650, MAIN, "kernel")])
    assert att["ns"] == {"gfvgn.rollout.record": 20}
    assert att["copy_ns"] == {"gfvgn.rollout.record": 10}
    ops = [(0, 7, "k", 99, "kernel")]
    assert hs.attribute(ops, {}, MARKS)["ns"] == {hs.UNATTRIBUTED: 7}


class _Ev:
    def __init__(self, name, kind, start, dur, corr=0, thread=MAIN):
        self._a = (name, kind, start, dur, corr, thread)

    def name(self):
        return self._a[0]

    def activity_type(self):
        return self._a[1]

    def start_ns(self):
        return self._a[2]

    def duration_ns(self):
        return self._a[3]

    def correlation_id(self):
        return self._a[4]

    def start_thread_id(self):
        return self._a[5]

    def device_type(self):
        return "DeviceType.CUDA" if self._a[1] in hs.DEVICE_KINDS \
            or self._a[1] == "gpu_user_annotation" else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a[1] in ("user_annotation", "gpu_user_annotation")


EVENTS = [
    _Ev("benchmark.profiled_stretch", "user_annotation", 0, 1000),
    _Ev("gfvgn.rollout.step", "user_annotation", 10, 300),
    _Ev("gfvgn.rollout.step", "gpu_user_annotation", 60, 200),
    _Ev("aten::mm", "cpu_op", 20, 30),
    _Ev("cudaLaunchKernel", "cuda_runtime", 40, 5, corr=7),
    _Ev("gemm", "kernel", 60, 200, corr=7),
    _Ev("gfvgn.rollout.record", "user_annotation", 320, 80),
    _Ev("cudaMemcpyAsync", "cuda_runtime", 330, 30, corr=8),
    _Ev("Memcpy DtoH", "gpu_memcpy", 340, 40, corr=8),
    _Ev("harness", "python_function", 600, 390),
]


class _OlderEv(_Ev):
    """An event of a torch whose profiler events have no activity type."""

    def activity_type(self):
        raise AttributeError("activity_type")


@pytest.mark.parametrize("ev", [_Ev, _OlderEv], ids=["typed", "untyped"])
def test_kineto_events_are_read_and_the_gaps_named(ev):
    events = [ev(*e._a[:4], corr=e._a[4], thread=e._a[5]) for e in EVENTS]
    ops, calls, marks = hs.from_kineto(events)
    assert [(o[2], o[4]) for o in ops] == [("gemm", "kernel"),
                                           ("Memcpy DtoH", "copy")]
    assert calls == {7: (40, MAIN), 8: (330, MAIN)}
    assert [m[0] for m in marks] == ["gfvgn.rollout.step",
                                     "gfvgn.rollout.record"]
    att = hs.attribute(ops, calls, marks)
    assert att["ns"] == {"gfvgn.rollout.step": 200,
                         "gfvgn.rollout.record": 40}
    gaps = hs.name_gaps(events)
    # 380..1000 (the harness's own code), 260..340, 0..60
    assert [g[:2] for g in gaps] == [
        ["harness", "(no program span)"],
        ["gfvgn.rollout.step", "gfvgn.rollout.step"],
        ["aten::mm", "gfvgn.rollout.step"]]
    assert gaps[0][2] == pytest.approx(620e-9)


def _record(mode, trace=True):
    dev = {"steps": 2, "ms": {"gfvgn.fv.residual": 1.0,
                              "gfvgn.model.attention": 2.0,
                              "gfvgn.train.backward": 3.0,
                              "gfvgn.train.optimizer": 0.5},
           "copy_ms": {"gfvgn.rollout.record": 1.5},
           "record_bytes": 18e6, "unattributed": 0.01}
    host = {"steps": 2, "wall_ms": 30.0, "spans_per_step": 6.0,
            "ms": {"gfvgn.rollout.step": 20.0, "gfvgn.rollout.record": 9.0,
                   "gfvgn.rollout.export": 0.1}}
    ops = [flops.Op("processor_0.transolver.attention", 2e9, 4e6,
                    flops.PEAK_BF16),
           flops.Op("processor_0.transolver.mlp", 1e9, 8e6, flops.PEAK_BF16),
           flops.Op("processor_0.transolver.attention.backward", 4e9, 8e6,
                    flops.PEAK_BF16),
           flops.Op("gn_0.edge_mlp", 9e9, 9e6, flops.PEAK_BF16)]
    return {"mode": mode, "trace": trace, "ops": ops,
            "program": {"setup": {"envs_s": 4.0}, "device": dev,
                        "host": host, "gaps": []}}


@pytest.mark.parametrize("m", span_metrics(), ids=lambda m: m["name"])
def test_each_reader_reads_only_its_mode_and_traced_runs(m):
    read = spec.reader(m["name"])
    mode = "train" if m["moves"] == "train_ms" else "rollout"
    assert read(_record(mode, trace=False)) is None
    assert read({"mode": mode, "trace": True}) is None
    assert read(_record(mode)) > 0
    if m["moves"] != "setup_s":
        other = "rollout" if mode == "train" else "train"
        assert read(_record(other)) is None
    if m["name"] == "record_gbps.rollout":
        assert read(_record(mode)) == pytest.approx(12.0)
    if m["name"].startswith("attn_roofline."):
        # the forward's two Transolver operations over the span's 2 ms:
        # attention 2e9 / 989e12 s, MLP 8e6 B / 3.35e12 B/s
        bound = 2e9 / 989e12 + 8e6 / 3.35e12
        assert read(_record(mode)) == pytest.approx(100 * bound / 2e-3)
        assert read(dict(_record(mode), ops=[])) is None


def test_the_span_metrics_keep_to_the_contract():
    bench = spec.benchmark_file()
    cells = {w["name"] for w in bench["workloads"]}
    have = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    layers = {m["layer"] for m in bench["per_layer"]}
    names = []
    for m in span_metrics():
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span")
        assert m["layer"] in layers and have.count(m["name"]) == 1
        assert m["workloads"] and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            e2e = {e["name"] for e in spec.load_cell(w).end_to_end}
            assert m["moves"] in e2e
        names.append(m["name"])
    assert len(names) == len(set(names)) == len(SPAN_METRICS)


class _Prof:
    """What `trace.reduce_device` reads of a `torch.profiler.profile`."""

    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {})()
        self.profiler.kineto_results.events = lambda: events


def test_every_device_operation_is_in_the_record():
    """`ops_s`: each of twelve operations' device seconds a step by its
    full name; the breakdown keeps the ten longest, names cut to 160."""
    long = "k" * 200
    evs = [_Ev(f"op{i}", "kernel", 1000 * i, 10 * (i + 1))
           for i in range(11)]
    evs += [_Ev(long, "kernel", 20000, 5), _Ev(long, "kernel", 21000, 5)]
    got = tr.reduce_device(_Prof(evs), 2, 1e-4)
    assert got["ops_s"] == {**{f"op{i}": pytest.approx(5e-9 * (i + 1))
                               for i in range(11)},
                            long: pytest.approx(5e-9)}
    assert len(got["device_ops"]) == 10
    assert got["device_ops"][0] == ["op10", pytest.approx(110e-9)]
    assert got["busy_s"] == pytest.approx(sum(10 * (i + 1)
                                              for i in range(11)) * 1e-9
                                          + 10e-9)


@pytest.mark.parametrize("mode", ["train", "rollout"])
def test_a_traced_run_with_spans_carries_program_and_every_key(
        mode, monkeypatch):
    """On the CPU `run.py` profiles no stretch: a `--trace 1` record has
    set-up's and the third stretches' spans, and every key of a
    `--trace 0` result; the window runs with the spans off in both, and
    `--trace 0` turns no span on."""
    from gen_fvgn_tpu_torch.utils import spans
    name = next(w["name"] for w in spec.benchmark_file()["workloads"]
                if spec.load_cell(w["name"]).traffic["mode"] == mode)
    cell = tiny_cell(name)
    turned_on = []
    enable = spans.enable
    monkeypatch.setattr(spans, "enable",
                        lambda flag=True: (turned_on.append(bool(flag)),
                                           enable(flag))[1])
    for kind in (cells.Train, cells.Rollout):
        def window(self, seconds, _base=kind.window):
            assert not spans.enabled()
            return _base(self, seconds)
        monkeypatch.setattr(kind, "window", window)

    base, _ = run.execute(name, 2**31 + 23, 0.5, False, device="cpu",
                          cell=cell)
    assert True not in turned_on and "program" not in base
    got, lines = run.execute(name, 2**31 + 23, 0.5, True, device="cpu",
                             cell=cell)
    assert True in turned_on and not spans.enabled()
    assert set(base) <= set(got) and "program" in got
    assert list(got)[-1] == "checks"
    assert got["correct"] and base["correct"]
    prog = got["program"]
    assert prog["setup"]["envs_s"] > 0 and "device" not in prog
    host = prog["host"]
    step = "gfvgn.train.step" if mode == "train" else "gfvgn.rollout.step"
    assert host["ms"][step] > 0 and host["spans_per_step"] >= 3
    assert host["wall_ms"] > 0 and host["off_wall_ms"] > 0
    assert any("on / off - 1" in line for line in lines)
    assert lines[-1].startswith("check correct")
    assert "envs_s" in got["metrics"]
    if mode == "rollout":
        assert {"host_ms.rollout", "record_ms.rollout"} <= set(got["metrics"])
        assert any("host + record + export" in line for line in lines)
