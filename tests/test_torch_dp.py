"""PyTorch port, data parallelism: `parallel/multihost.py`, the collectives
of `parallel/dp.py`, and the dp train steps of both engines
(`make_train_step_block`, `MixedTrainStepBlock`, `make_train_step` with
`dp=True`) on 2 gloo ranks spawned on the CPU (`parallel/launch.py`),
against the port's single-process step at the global batch and against
the JAX package's step jitted over a 2-device mesh (`make_mesh(2)`; the
8 virtual CPU devices of tests/conftest.py).

Sizes, as the JAX package's `tests/test_parallel.py`: `cavity_quad_mesh(5)`,
TransFVGN_v2 at hidden 32, one message-passing block, 8 slices, 4 heads,
float32, global batch 8 (4 rows a rank), lr 5e-5. Limits, those of the JAX
dp test: loss rtol 1e-5, grad_norm rtol 1e-3, new states rtol 1e-4 + atol
1e-5, parameters after one step rtol 1e-3 + atol 2.2·lr (Adam's first step
is ±lr where a gradient is float32 noise around zero, so a sign flip moves
an element by 2·lr). Measured, the worst of the four steps (per-case,
per-case with microbatch 2, segment, mixed): against the single-process
step loss 9.4e-8, grad_norm 2.0e-7, states equal, parameters 1.67·lr
(mixed), normalizer 1.7e-10; against the JAX dp step loss equal,
grad_norm 1.2e-6, states 8.2e-8 (scale 1.0), parameters 0.60·lr,
normalizer 2.0e-9; the two ranks the same bits.
"""

import numpy as np
import pytest
import torch

import jax

from torch_port_common import CASE_KW, to_plain_dict
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

LR = 5e-5
BASE = dict(batch_size=8, dataset_size=8, mxu_dtype="float32",
            hidden_size=32, message_passing_num=1, slice_num=8, attn_heads=4,
            dp_devices=2)


def _case(pkg, n=5, mu=0.05):
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    return syn.synthetic_case(syn.cavity_quad_mesh(n), **dict(CASE_KW, mu=mu))


# ---- multihost ----

@pytest.mark.parametrize("n,count", [(8, 2), (8, 4), (7, 3), (5, 1)])
def test_multihost_matches_jax(n, count):
    """`host_shard` and `local_batch_rows` give the JAX functions' items
    and rows for every rank, including the error for a batch that does not
    divide; without a process group `world()` is (0, 1) and `initialize()`
    does nothing."""
    from gen_fvgn_tpu.parallel import multihost as jmh
    from gen_fvgn_tpu_torch.parallel import multihost as tmh
    items = [f"case{i}" for i in range(n)]
    for pid in range(count):
        assert tmh.host_shard(items, pid, count) == \
            jmh.host_shard(items, pid, count)
        if n % count:
            with pytest.raises(ValueError, match="not divisible") as t:
                tmh.local_batch_rows(n, pid, count)
            with pytest.raises(ValueError, match="not divisible") as j:
                jmh.local_batch_rows(n, pid, count)
            assert str(t.value) == str(j.value)
        else:
            np.testing.assert_array_equal(
                tmh.local_batch_rows(n, pid, count),
                jmh.local_batch_rows(n, pid, count))
    assert tmh.world() == (0, 1) and tmh.initialize() == (0, 1)
    assert tmh.host_shard(items) == items
    np.testing.assert_array_equal(tmh.local_batch_rows(n), np.arange(n))


def test_collectives_and_broadcast_on_two_ranks(tmp_path):
    """Each collective on known values; `broadcast_state` gives every rank
    rank 0's weights, Adam moments and step counts, normalizer, step and
    epoch, though each rank made its own."""
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from torch_dp_workers import collectives
    small = dict(hidden_size=32, message_passing_num=1, net="FVGN")
    r0, r1 = spawn(collectives, 2, small, workdir=str(tmp_path))
    for r in (r0, r1):
        assert r["sum"].tolist() == [2.0, 1.0]
        assert r["mean"].tolist() == [1.0]
        assert r["grads"][0].tolist() == [[1.5] * 3] * 2
        assert r["grads"][1].tolist() == [0.0, 0.5, 1.0, 1.5]
        assert r["rows"].tolist() == [[0., 1.], [2., 3.], [4., 5.],
                                      [10., 11.], [12., 13.], [14., 15.]]
        assert r["counters"] == (5, 7) and r["acc_count"] == 3.0
    assert r0["local"].tolist() == [0, 1, 2, 3]
    assert r1["local"].tolist() == [4, 5, 6, 7]
    assert all(torch.equal(a, b) for a, b in zip(r0["params"], r1["params"]))
    assert set(r0["adam"]) == set(r1["adam"]) >= {"exp_avg", "exp_avg_sq"}
    assert all(torch.equal(r0["adam"][k], r1["adam"][k]) for k in r0["adam"])


def test_dp_step_without_a_group_raises():
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.training.train import make_train_step
    from gen_fvgn_tpu_torch.training.train_block import (
        MixedTrainStepBlock, init_train_state_block, make_train_step_block)
    cfg = Config(**BASE)
    _, sim = init_train_state_block(cfg, device="cpu")
    for build in (make_train_step_block, make_train_step,
                  MixedTrainStepBlock):
        with pytest.raises(RuntimeError, match="process group"):
            build(cfg, sim, device="cpu", dp=True)


def test_dp_step_returns_its_rows_and_gathers_only_for_the_payback(
        tmp_path):
    """A dp step returns its rank's 4 rows of the global 8; the pool is
    left as it was by a step that is not paid back, and a paid-back step
    gathers the 8 rows from both ranks into it."""
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from torch_dp_workers import rows_and_payback
    spec = dict(cfg=dict(BASE, engine="block"),
                cases=[_case("gen_fvgn_tpu_torch")], device="cpu", seed=0)
    for r in spawn(rows_and_payback, 2, spec, workdir=str(tmp_path)):
        assert r["local_rows"] == 4 and r["skipped"] is None
        assert r["unchanged"] and r["paid_back"]
        assert r["paid_rows"] == r["batch"] == 8


def test_wrapper_cost_on_one_rank():
    """`tools/dp_check.wrapper_cost` (chip_smoke.py's phase "dp" (a)) on
    one gloo rank on the CPU: the parameters with and without the wrapper
    the same bits, the timed steps of each, no device time."""
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.tools.dp_check import wrapper_cost
    spec = dict(cfg=dict(BASE, engine="block", dp_devices=1),
                cases=[_case("gen_fvgn_tpu_torch")], device="cpu", seed=0,
                steps=2, timed=2)
    out, = spawn(wrapper_cost, 1, spec)
    assert out["same_bits"]
    assert len(out["ms_plain"]) == len(out["ms_dp"]) == 2
    assert out["busy_plain"] is None and out["busy_dp"] is None


# ---- the dp steps on 2 ranks ----

def _jax_start_block(cfg):
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.training.pool import EnvPool
    from gen_fvgn_tpu.training.train_block import init_train_state_block
    jcfg = JConfig(engine="block", **cfg)
    pool = EnvPool([], jcfg, seed=0, cases=[_case("gen_fvgn_tpu")],
                   engine="block")
    ci, idxs = pool.block_batches(step_seed=0)[0]
    dyn, static = pool.gather_block(idxs), pool.statics[ci]
    state, apply_fn = init_train_state_block(jcfg, dyn, static, seed=0)
    return jcfg, dyn, static, state, apply_fn


def _jax_start_segment(cfg):
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.training.pool import EnvPool
    from gen_fvgn_tpu.training.train import init_train_state
    jcfg = JConfig(engine="segment", **cfg)
    pool = EnvPool([], jcfg, seed=0, pad_multiple=8,
                   cases=[_case("gen_fvgn_tpu")])
    batch = pool.gather_batch(pool.batch_indices(step_seed=0)[0])
    state, apply_fn = init_train_state(jcfg, batch, seed=0)
    return jcfg, batch, state, apply_fn


def _jax_dp_block(jcfg, dyn, static, state, apply_fn):
    from gen_fvgn_tpu.parallel.dp import (make_mesh, shard_block_batch,
                                          shard_static, shard_train_state)
    from gen_fvgn_tpu.training.train_block import make_train_step_block
    mesh = make_mesh(2)
    step = make_train_step_block(jcfg, apply_fn, donate=False)
    return step(shard_train_state(state, mesh),
                shard_block_batch(dyn, mesh, batch_size=8),
                shard_static(static, mesh))


def _jax_dp_segment(jcfg, batch, state, apply_fn):
    from gen_fvgn_tpu.parallel.dp import (make_mesh, shard_batch,
                                          shard_train_state)
    from gen_fvgn_tpu.training.train import make_train_step
    mesh = make_mesh(2)
    step = make_train_step(jcfg, apply_fn, donate=False)
    return step(shard_train_state(state, mesh), shard_batch(batch, mesh))


def _port_start(engine, jparams, path):
    """A port checkpoint slot holding the JAX initialisation's weights."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.training.train import init_train_state
    from gen_fvgn_tpu_torch.training.train_block import \
        init_train_state_block
    init = init_train_state_block if engine == "block" else init_train_state
    state, sim = init(Config(engine=engine, **BASE), seed=5, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(
        jax.tree_util.tree_map(np.asarray, jparams))))
    save_state(state, str(path))
    return str(path)


@pytest.fixture(scope="module")
def jax_block():
    """The JAX block pool's first batch, statics and initialisation."""
    return _jax_start_block(BASE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_block):
    """Every spec's step on 2 gloo ranks (one spawn), in this process at
    the global batch, and, for the per-case steps, JAX's step on a
    2-device mesh from the same weights."""
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.tools.dp_check import run_steps
    from torch_dp_workers import several
    tmp = tmp_path_factory.mktemp("dp")
    T = "gen_fvgn_tpu_torch"
    jax_runs = {}
    jb = jax_block
    jm = (jb[0].replace(microbatch=2),) + jb[1:]
    js = _jax_start_segment(BASE)
    starts = {"block": _port_start("block", jb[3].params, tmp / "b.state"),
              "segment": _port_start("segment", js[2].params,
                                     tmp / "s.state")}
    jax_runs["block"] = _jax_dp_block(*jb)
    jax_runs["block_mb2"] = _jax_dp_block(*jm)
    jax_runs["segment"] = _jax_dp_segment(*js)
    one = [_case(T)]
    specs = {
        "block": dict(cfg=dict(BASE, engine="block"), cases=one,
                      start=starts["block"]),
        "block_mb2": dict(cfg=dict(BASE, engine="block", microbatch=2),
                          cases=one, start=starts["block"]),
        "segment": dict(cfg=dict(BASE, engine="segment"), cases=one,
                        pad_multiple=8, start=starts["segment"]),
        "mixed": dict(cfg=dict(BASE, engine="block", dataset_size=12,
                               mixed_case_batches=True),
                      cases=[_case(T), _case(T, n=4, mu=0.1)], mixed=True),
    }
    specs = {k: dict(v, device="cpu", steps=1, seed=0)
             for k, v in specs.items()}
    ranks = spawn(several, 2, [dict(s, dp=True) for s in specs.values()],
                  workdir=str(tmp))
    out = {}
    for i, (name, spec) in enumerate(specs.items()):
        out[name] = dict(ranks=[r[i] for r in ranks],
                         single=run_steps(0, 1, dict(spec, dp=False)),
                         jax=jax_runs.get(name))
    return out


ALL = ["block", "block_mb2", "segment", "mixed"]


@pytest.mark.parametrize("name", ALL)
def test_dp_step_matches_the_single_process_step(runs, name):
    """Rank 0 against the port's step at the global batch in one process,
    the same batch drawn; both ranks hold the same parameters and pool."""
    from gen_fvgn_tpu_torch.tools.dp_check import compare
    r = runs[name]
    gaps = compare(r["single"], r["ranks"], LR, steps=1)
    assert gaps["ok"], gaps
    assert r["ranks"][0]["step"] == r["single"]["step"] == 1


@pytest.mark.parametrize("name", ["block", "block_mb2", "segment"])
def test_dp_step_matches_the_jax_dp_step(runs, name):
    """Rank 0 against the JAX step jitted over a 2-device mesh on the same
    batch from the same weights: loss, gradient norm, new states and
    parameters within the JAX dp test's limits."""
    from torch_port_common import jax_flat
    r = runs[name]
    s_j, m_j, u_j = r["jax"]
    got = r["ranks"][0]
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(m_j.loss), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(m_j.grad_norm),
                               rtol=1e-3)
    np.testing.assert_allclose(got["uvp_first"], np.asarray(u_j),
                               rtol=1e-4, atol=1e-5)
    jp = jax_flat(s_j.params)
    assert set(jp) == set(got["params"])
    for k, v in jp.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-3,
                                   atol=2.2 * LR, err_msg=k)


@pytest.mark.parametrize("name", ALL)
def test_global_normalizer_statistics(runs, name):
    """The normalizer after a dp step holds the global batch's sums (one
    all-reduce of the packed [2F+1] sums): the single-process statistics
    within 1e-6 relative, one accumulation; the JAX dp step's too."""
    r = runs[name]
    got, ref = r["ranks"][0]["norm"], r["single"]["norm"]
    assert float(got["num_acc"]) == 2.0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert float(got["acc_count"]) > 1.0 + 8 * 16
    if r["jax"] is not None:
        for k in ref:
            np.testing.assert_allclose(
                got[k], np.asarray(getattr(r["jax"][0].norm_state, k)),
                rtol=1e-5, err_msg=k)


def test_microbatch_row_order_matches_jax(monkeypatch, jax_block):
    """Batch 8, microbatch 2, dp 2: JAX's step cuts 2 chunks of 4 rows,
    each holding 2 rows of each device's block; rank r's chunk k
    (`microbatch_order` on its own 4 rows) holds the rows JAX's device r
    holds in chunk k, and the single-process port step's chunk k is JAX's
    chunk k. JAX's chunks are read from the arrays its step hands to
    `lax.scan` (run eagerly), each row known by its random state."""
    from gen_fvgn_tpu.training import train_block as jtb
    from gen_fvgn_tpu_torch.parallel.multihost import local_batch_rows
    from gen_fvgn_tpu_torch.training.train_block import microbatch_order
    jcfg, dyn, static, state, apply_fn = jax_block
    jcfg = jcfg.replace(microbatch=2)
    uvp = np.random.default_rng(0).normal(size=dyn.uvp.shape)
    dyn = dyn.replace(uvp=jax.numpy.asarray(uvp, np.float32))

    class Stop(Exception):
        pass

    seen = {}

    def scan(body, init, xs, *a, **k):
        seen["uvp"] = np.asarray(xs.uvp)
        raise Stop
    monkeypatch.setattr(jax.lax, "scan", scan)
    step = jtb.make_train_step_block(jcfg, apply_fn, donate=False)
    with jax.disable_jit(), pytest.raises(Stop):
        step(state, dyn, static)
    flat = np.asarray(dyn.uvp).reshape(8, -1)
    jax_chunks = [[int(np.flatnonzero((flat == row.reshape(-1)).all(1))[0])
                   for row in chunk] for chunk in seen["uvp"]]
    assert len(jax_chunks) == 2
    single = microbatch_order(8, 2, 2)
    for k, rows in enumerate(jax_chunks):
        ranks = np.concatenate([
            local_batch_rows(8, r, 2)[microbatch_order(4, 2, 1)[k].numpy()]
            for r in range(2)])
        assert ranks.tolist() == rows
        assert single[k].tolist() == rows
    assert microbatch_order(4, 2, 2) is None     # at the per-device peak
    assert microbatch_order(12, 8, 1) is None    # not divisible
