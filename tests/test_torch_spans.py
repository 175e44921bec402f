"""PyTorch port, its spans (`gen_fvgn_tpu_torch/utils/spans.py`): off they
record nothing and return one shared null context; on they record names,
parents and attributes, and under `torch.profiler` they lie on its host
timeline at the times they record. At a tiny mesh on the CPU (plain
kernels), a train step and a rollout of each engine open the program's
spans nested as PERF.md §3 lists them, and give the same bits with the
spans on as off."""

import threading

import numpy as np
import pytest
import torch

from gen_fvgn_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def spans_off():
    spans.enable(False)
    spans.take()
    yield
    spans.enable(False)
    spans.take()


# ------------------------------------------------------------ the module

@pytest.mark.parametrize("attrs", [{}, {"t": 3}, {"bytes": 17, "n": 2}])
def test_off_returns_the_shared_null_context_and_records_nothing(attrs):
    a = spans.span("gfvgn.a", **attrs)
    assert a is spans.span("gfvgn.b") is spans._NULL
    with a as got:
        spans.note(bytes=1)
    assert got is None and not spans.enabled()
    assert spans.take() == []


def test_on_records_names_parents_and_attributes_and_take_clears():
    spans.enable(True)
    with spans.span("gfvgn.outer", steps=2) as outer:
        for t in range(2):
            with spans.span("gfvgn.inner", t=t):
                with spans.span("gfvgn.leaf"):
                    pass
                spans.note(bytes=10 * t)
    with spans.span("gfvgn.next"):
        pass
    got = spans.take()
    assert [s.name for s in got] == ["gfvgn.outer", "gfvgn.inner",
                                     "gfvgn.leaf", "gfvgn.inner",
                                     "gfvgn.leaf", "gfvgn.next"]
    assert [s.parent for s in got] == [-1, 0, 1, 0, 3, -1]
    assert got[0] is outer and outer.attrs == {"steps": 2}
    assert got[1].attrs == {"t": 0, "bytes": 0}
    assert got[3].attrs == {"t": 1, "bytes": 10}
    for s in got:
        assert 0 < s.start_ns <= s.end_ns and s.seconds >= 0
    for s in got[1:5]:
        p = got[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert spans.take() == []


def test_each_thread_has_its_own_stack():
    spans.enable(True)

    def work():
        with spans.span("gfvgn.thread"):
            with spans.span("gfvgn.thread.inner"):
                pass

    with spans.span("gfvgn.main"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    got = spans.take()
    assert [(s.name, s.parent) for s in got] == [
        ("gfvgn.main", -1), ("gfvgn.thread", -1), ("gfvgn.thread.inner", 1)]


def test_a_span_open_across_take_ends_in_the_list_taken():
    spans.enable(True)
    with spans.span("gfvgn.open"):
        first = spans.take()
        with spans.span("gfvgn.after"):
            pass
    second = spans.take()
    assert [s.name for s in first] == ["gfvgn.open"] and first[0].end_ns > 0
    assert [(s.name, s.parent) for s in second] == [("gfvgn.after", -1)]


@pytest.mark.parametrize("on", [True, False])
def test_under_the_profiler_a_span_is_an_annotation_on_its_clock(on):
    """On, the span appears among the profiler's host events as a user
    annotation of the same name, and its recorded start lies within 5 ms
    of the annotation's; off, it does not appear."""
    from torch.profiler import ProfilerActivity, profile
    spans.enable(on)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("gfvgn.clock"):
            torch.ones(64).mul_(2.0)
    spans.enable(False)
    got = spans.take()
    marks = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "gfvgn.clock"]
    if not on:
        assert got == [] and marks == []
        return
    assert len(got) == 1 and len(marks) == 1
    assert marks[0].is_user_annotation()
    assert abs(got[0].start_ns - marks[0].start_ns()) < 5_000_000
    assert abs(got[0].end_ns - marks[0].end_ns()) < 5_000_000


def test_off_costs_less_than_an_ungated_annotation():
    """Off, a span is one global check (0.5 us on a CPU core) against
    15 us for `record_function` outside a profile."""
    import timeit

    def gated():
        with spans.span("gfvgn.cost", t=1):
            pass

    def ungated():
        with torch.profiler.record_function("gfvgn.cost"):
            pass
    off = min(timeit.repeat(gated, number=2000, repeat=5))
    rf = min(timeit.repeat(ungated, number=2000, repeat=5))
    assert off < rf


# ---------------------------------------------------- the program's spans

ROOTS = {"gfvgn.setup.envs", "gfvgn.pool.gather", "gfvgn.pool.payback",
         "gfvgn.train.step", "gfvgn.rollout.request"}
PARENT = {"gfvgn.train.backward": "gfvgn.train.step",
          "gfvgn.train.optimizer": "gfvgn.train.step",
          "gfvgn.rollout.step": "gfvgn.rollout.request",
          "gfvgn.rollout.record": "gfvgn.rollout.request",
          "gfvgn.rollout.export": "gfvgn.rollout.request"}
MODEL = ("gfvgn.fv.residual", "gfvgn.model.attention")
N_STEPS = 2


def _cfg(engine):
    from gen_fvgn_tpu_torch.config import Config
    return Config(net="TransFVGN_v2", hidden_size=32, message_passing_num=1,
                  mxu_dtype="float32", batch_size=2, dataset_size=2,
                  engine=engine)


def _pool(cfg):
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    case = synthetic_case(cavity_quad_mesh(6), continuity=1, convection=1,
                          grad_p=1, mu=0.05, sigma=(1, 1, 1))
    return EnvPool([], cfg, seed=0, cases=[case], dataset_size=2,
                   engine=cfg.engine, device="cpu")


def _train(engine):
    from gen_fvgn_tpu_torch.training import train as tmod
    from gen_fvgn_tpu_torch.training import train_block as bmod
    cfg = _cfg(engine)
    pool = _pool(cfg)
    if engine == "block":
        state, sim = bmod.init_train_state_block(cfg, seed=0, device="cpu")
        step = bmod.make_train_step_block(cfg, sim, device="cpu")
        _, idxs = pool.block_batches(step_seed=1)[0]
        state, m, new = step(state, pool.gather_block(idxs), pool.statics[0])
    else:
        state, sim = tmod.init_train_state(cfg, seed=0, device="cpu")
        step = tmod.make_train_step(cfg, sim, device="cpu")
        idxs = pool.batch_indices(step_seed=1)[0]
        state, m, new = step(state, pool.gather_batch(idxs))
    pool.payback(idxs, new)
    return {"loss": m.loss.numpy(), "new": new.numpy(),
            **{n: p.detach().numpy().copy()
               for n, p in sim.named_parameters()}}


def _rollout(engine):
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from gen_fvgn_tpu_torch.solve.rollout import rollout
    from gen_fvgn_tpu_torch.solve.rollout_block import rollout_block
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    cfg = _cfg(engine)
    pool = _pool(cfg)
    ns = init_normalizer(cfg.node_input_size - cfg.node_phi_size,
                         device="cpu")
    idxs = np.arange(2)
    if engine == "block":
        sim = make_simulator_block(cfg, device="cpu", seed=0)
        hist = rollout_block(cfg, sim, ns, pool.gather_block(idxs),
                             pool.statics[0], N_STEPS,
                             export_fn=lambda *a: None)
    else:
        sim = make_simulator(cfg, device="cpu", seed=0)
        hist = rollout(cfg, sim, ns, pool.gather_batch(idxs), N_STEPS,
                       export_fn=lambda *a: None)
    return {f"{k}.{r['step']}": v for r in hist for k, v in r.items()
            if k != "step"}


RUNS = {"segment-train": lambda: _train("segment"),
        "block-train": lambda: _train("block"),
        "segment-rollout": lambda: _rollout("segment"),
        "block-rollout": lambda: _rollout("block")}


def _run(kind, on):
    spans.enable(on)
    try:
        torch.manual_seed(0)
        out = RUNS[kind]()
    finally:
        spans.enable(False)
    return out, spans.take()


@pytest.fixture(scope="module")
def runs():
    spans.enable(False)
    spans.take()
    return {(kind, on): _run(kind, on) for kind in RUNS
            for on in (True, False)}


@pytest.mark.parametrize("kind", list(RUNS))
def test_the_program_opens_its_spans_nested(runs, kind):
    _, got = runs[(kind, True)]
    names = [s.name for s in got]
    step = "gfvgn.train.step" if "train" in kind else "gfvgn.rollout.step"
    for s in got:
        parent = got[s.parent].name if s.parent >= 0 else None
        if s.name in ROOTS:
            assert parent is None, (s.name, parent)
        elif s.name in MODEL:
            assert parent == step, (s.name, parent)
        else:
            assert parent == PARENT[s.name], (s.name, parent)
        assert s.end_ns >= s.start_ns
    assert names[0] == "gfvgn.setup.envs"
    assert got[0].attrs == {"n": 2}
    for name in MODEL:
        assert name in names
    if "train" in kind:
        assert names.count("gfvgn.train.step") == 1
        for name in ("gfvgn.pool.gather", "gfvgn.train.backward",
                     "gfvgn.train.optimizer", "gfvgn.pool.payback"):
            assert names.count(name) == 1, name
        assert next(s for s in got if s.name == "gfvgn.train.step"
                    ).attrs == {"step": 0}
    else:
        req = [s for s in got if s.name == "gfvgn.rollout.request"]
        assert len(req) == 1 and req[0].attrs == {"steps": N_STEPS}
        for name in ("gfvgn.rollout.step", "gfvgn.rollout.record",
                     "gfvgn.rollout.export"):
            assert [s.attrs["t"] for s in got if s.name == name] == \
                list(range(N_STEPS)), name
        assert names.count("gfvgn.fv.residual") == N_STEPS


@pytest.mark.parametrize("kind", list(RUNS))
def test_outputs_are_the_same_bits_with_spans_on_and_off(runs, kind):
    on, _ = runs[(kind, True)]
    off, got_off = runs[(kind, False)]
    assert got_off == []
    assert on.keys() == off.keys()
    for k in on:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


@pytest.mark.parametrize("kind", ["segment-rollout", "block-rollout"])
def test_the_record_span_counts_the_records_bytes(runs, kind):
    out, got = runs[(kind, True)]
    records = [s for s in got if s.name == "gfvgn.rollout.record"]
    for s in records:
        nbytes = sum(v.nbytes for k, v in out.items()
                     if k.endswith(f".{s.attrs['t']}"))
        assert s.attrs["bytes"] == nbytes > 0
