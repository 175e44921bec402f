"""PyTorch port, the segment engine's bucket tiers (`bucket_tiers=True`,
`pre_train --engine segment --bucket-tiers 1`) against the JAX package's
device-resident pool: two cases of different size (a Navier-Stokes cavity
of 5 x 5 cells, 36 nodes, and a wave cavity of 12 x 12 cells, 169 nodes)
pad to their own sizes (128 and 256 nodes) and form two tiers.

Held: the tiers and each environment's tier, `batch_indices` (batches
within a tier, drawn as the JAX pool draws them), every field of each
gathered batch (equal, but the WLSQ moments within 1e-5 of their scale:
each package sums them in its own order, as in
tests/test_torch_segment_train.py), the refusal of a batch that mixes
tiers, payback and the wave sources per tier (the states bit-equal), and 2
epochs of `train()` at lr 5e-7 with the limits of the segment loop's test
(tests/test_torch_segment_train.py; measured here: the loss 8.6e-8, its
continuity and momentum parts 2.2e-7, the pressure outlet 1.4e-5, gradient
norms 5.1e-7, the states of both tiers within 3.6e-6).
"""

import dataclasses
import glob

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_segment import cases, configs
from test_torch_segment_train import _monitor
from torch_port_common import to_plain_dict

J, T = "gen_fvgn_tpu", "gen_fvgn_tpu_torch"


def _two_sizes(pkg, jax_statics=False):
    """The NS cavity of 5 x 5 cells and the wave cavity of 12 x 12 cells;
    with `jax_statics` each mesh carries the WLSQ stencil and moments the
    JAX package computes, so that both pools see the same statics."""
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    ns, = cases(pkg, 5)
    wave = syn.wave_case(syn.cavity_quad_mesh(12),
                         source_frequency=(1.0, 1.0, 3.0),
                         source_strength=(0.02, 0.02, 0.02), dt=0.05)
    if jax_statics:
        from gen_fvgn_tpu.training.pool import prepare_mesh_statics
        for c, jc in zip((ns, wave), _two_sizes(J)):
            mesh = prepare_mesh_statics(dict(jc["mesh"]), "2nd")
            c["mesh"] = dict(c["mesh"], **{
                k: np.asarray(mesh[k]) for k in ("stencil", "wlsq_S",
                                                 "wlsq_B", "wlsq_scale")})
    return [ns, wave]


def _pools(dataset_size=8, seed=3):
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    jc, tc = configs("TransFVGN_v2", batch_size=2, dataset_size=dataset_size)
    jpool = JPool([], jc, seed=seed, cases=_two_sizes(J),
                  device_resident=True, bucket_tiers=True)
    tpool = TPool([], tc, seed=seed, cases=_two_sizes(T), engine="segment",
                  bucket_tiers=True, device="cpu")
    return jpool, tpool


def _fields(batch):
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(batch)}


def test_tiers_batches_and_gathers_match_jax():
    jpool, tpool = _pools()
    assert tpool.n_tiers == jpool.n_tiers == 2
    assert tpool._case_tier == jpool._case_tier == [0, 1]
    assert tpool._env_tier == jpool._env_tier
    assert [dataclasses.astuple(s) for s in tpool.case_sizes] == \
        [dataclasses.astuple(s) for s in jpool.case_sizes]
    assert [s.n_nodes for s in tpool.case_sizes] == [128, 256]
    assert sorted(tpool._tier_data) == [0, 1]
    for s in (0, 1, 7):
        jb, tb = jpool.batch_indices(s), tpool.batch_indices(s)
        assert len(tb) == len(jb) == 4
        assert all(np.array_equal(a, b) for a, b in zip(jb, tb))
        for idxs in tb:
            assert len({tpool._env_tier[int(i)] for i in idxs}) == 1
    for idxs in tpool.batch_indices(1):
        jf = _fields(jpool.gather_batch(idxs))
        tf = {k: v.numpy() for k, v in dataclasses.asdict(
            tpool.gather_batch(idxs)).items()}
        assert set(jf) == set(tf)
        for k in jf:
            assert tf[k].shape == jf[k].shape, k
            if k.startswith("wlsq_"):
                scale = max(np.abs(jf[k]).max(), 1e-30)
                assert np.abs(tf[k] - jf[k]).max() <= 1e-5 * scale, k
            else:
                np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    mixed = np.asarray([0, 1])           # environment 0 is NS, 1 is wave
    assert tpool._env_tier[0] != tpool._env_tier[1]
    with pytest.raises(ValueError, match="mixes bucket tiers"):
        tpool.gather_batch(mixed)
    with pytest.raises(ValueError, match="mixes bucket tiers"):
        jpool.gather_batch(mixed)


def test_payback_and_wave_sources_per_tier_match_jax():
    """Random states paid back through every batch of a step, then the
    wave sources: each tier's stack equal to the JAX pool's, bit for bit;
    a single-tier pool keeps the one stack it always had."""
    jpool, tpool = _pools()
    rng = np.random.default_rng(0)
    for idxs in tpool.batch_indices(2):
        n_pad = tpool.case_sizes[tpool.envs[int(idxs[0])].case_idx].n_nodes
        uvp = rng.normal(size=(len(idxs), n_pad, 3)).astype(np.float32)
        jpool.payback(idxs, jnp.asarray(uvp))
        tpool.payback(idxs, torch.from_numpy(uvp))
    jpool.inject_wave_sources()
    tpool.inject_wave_sources()
    assert [e.age for e in tpool.envs] == [e.age for e in jpool.envs]
    for t in range(2):
        np.testing.assert_array_equal(tpool._tier_data[t].uvp.numpy(),
                                      np.asarray(jpool._device_data[t].uvp))
    for i in range(len(tpool)):
        np.testing.assert_array_equal(tpool.host_uvp(i), jpool.host_uvp(i))
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    _, tc = configs("TransFVGN_v2", batch_size=2, dataset_size=4)
    one = TPool([], tc, cases=_two_sizes(T)[:1], engine="segment",
                bucket_tiers=True, device="cpu")
    assert one.n_tiers == 1 and list(one._tier_data) == [0]


def test_train_two_epochs_with_tiers_matches_jax(tmp_path, monkeypatch):
    """`train()` of the segment engine with bucket tiers (FVGN), 2 epochs
    of 2 inner steps over the two sizes (4 environments, batch 2: a batch
    of each tier a step), a re-roll after each epoch, the wave sources; both
    sides from the JAX loop's own initialisation, on the same WLSQ
    statics. One train-step callable serves both tiers."""
    from gen_fvgn_tpu.training.loop import train as jtrain
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu.training.train import init_train_state as jinit
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.training import loop as tloop
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    from gen_fvgn_tpu_torch.training.train import init_train_state
    kw = dict(batch_size=2, dataset_size=4, max_inner_steps=2, n_epochs=2,
              average_sequence_length=4, lr=5e-7, bucket_tiers=True)
    jc, tc = configs("FVGN", **kw)
    jpool = JPool([], jc, seed=0, cases=_two_sizes(J), device_resident=True,
                  bucket_tiers=True)
    first = jpool.gather_batch(jpool.batch_indices(step_seed=0)[0])
    jstate, _ = jinit(jc.replace(dataset_size=len(jpool)), first, seed=0)
    tstate, sim = init_train_state(tc, seed=5, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))), strict=True)
    start = str(tmp_path / "start.state")
    save_state(tstate, start)

    pools = {"jax": [], "port": []}
    for name, cls in (("jax", JPool), ("port", TPool)):
        orig = cls.__init__

        def init(self, *a, _orig=orig, _into=pools[name], **k):
            _orig(self, *a, **k)
            _into.append(self)
        monkeypatch.setattr(cls, "__init__", init)
    steps = []
    make = tloop.make_train_step
    monkeypatch.setattr(tloop, "make_train_step",
                        lambda *a, **k: steps.append(1) or make(*a, **k))
    jout = jtrain(jc, cases=_two_sizes(J), seed=0,
                  log_base_dir=str(tmp_path / "jax"))
    tout = tloop.train(tc, cases=_two_sizes(T, jax_statics=True), seed=0,
                       log_base_dir=str(tmp_path / "port"),
                       resume_from=start, device="cpu")
    assert len(steps) == 1
    assert int(jout.epoch) == tout.epoch == 2
    assert int(jout.step) == tout.step == 2 * 2 * 2
    jm, tm = _monitor(str(tmp_path / "jax")), _monitor(str(tmp_path / "port"))
    assert set(jm) == set(tm) and len(tm["loss"]) == 2
    np.testing.assert_array_equal(tm["lr"], jm["lr"])
    limits = dict(loss=1e-5, loss_cont=1e-5, loss_mom=1e-5, loss_press=1e-4,
                  grad_norm=1e-4)
    for key, lim in limits.items():
        rel = np.abs(tm[key] - jm[key]) / np.maximum(np.abs(jm[key]), 1e-30)
        assert rel.max() <= lim, (key, rel)
    (jp,), (tp,) = pools["jax"], pools["port"]
    assert tp.n_tiers == 2 and tp._age_order == jp._age_order
    assert [e.age for e in tp.envs] == [e.age for e in jp.envs]
    for t in range(2):
        gap = np.abs(tp._tier_data[t].uvp.numpy()
                     - np.asarray(jp._device_data[t].uvp)).max()
        assert gap <= 1e-4, (t, gap)


def test_pre_train_segment_with_bucket_tiers(tmp_path, monkeypatch):
    """`pre_train --engine segment --bucket-tiers 1` on two case
    directories of different size: it trains (finite losses, checkpoints)
    on a pool of two tiers."""
    from gen_fvgn_tpu_torch.scripts import pre_train
    from gen_fvgn_tpu_torch.tools.case_files import write_cavity_case
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    data = tmp_path / "data"
    write_cavity_case(str(data / "small"), n=4)
    write_cavity_case(str(data / "large"), n=12, kind="tri",
                      boundary="channel")
    made = []
    orig = EnvPool.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        made.append(self)
    monkeypatch.setattr(EnvPool, "__init__", init)
    pre_train.main([
        "--dataset-dir", str(data), "--log-dir", str(tmp_path / "runs"),
        "--epochs", "2", "--batch-size", "2", "--dataset-size", "4",
        "--max-inner-steps", "1", "--mxu-dtype", "float32",
        "--net", "FVGN", "--engine", "segment", "--bucket-tiers", "1",
        "--device", "cpu"])
    pool, = made
    assert pool.engine == "segment" and pool.n_tiers == 2
    mon = _monitor(str(tmp_path / "runs"))
    assert len(mon["loss"]) == 2 and np.isfinite(mon["loss"]).all()
    assert glob.glob(str(tmp_path / "runs" / "*" / "*" / "states" /
                         "*.state"))
