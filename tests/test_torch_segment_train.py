"""PyTorch port, the segment engine's run around the step against the JAX
package's: the device-resident pool (`gather_batch`, `payback`,
`reset_env`, `inject_wave_sources` from one seed), a 3-step `rollout`,
`solve_adam` (with `max_chunks_per_step` and a chunked batch) and
`solve_lbfgs`, and 3 epochs of `train()`.

Sizes: float32, hidden 32, one message-passing block a processor,
TransFVGN_v2, the cavities of tests/test_torch_segment.py; weights and
normalizer statistics from NumPy seeds. Each test states its measured
deviations; the limits are the block engine's
(tests/test_torch_rollout.py, tests/test_torch_solve.py,
tests/test_torch_loop.py), tighter where the segment engine meets them.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_segment import (batches, cases, configs, port_simulator,
                                segment_params)
from torch_port_common import (jax_norm_state, numpy_norm_stats,
                               to_plain_dict, torch_norm_state)

J, T = "gen_fvgn_tpu", "gen_fvgn_tpu_torch"
LOSSES = ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ns_and_wave(pkg, n=5, jax_statics=False):
    """A Navier-Stokes case with 10 boundary conditions (5 inlet speeds x
    2 viscosities) and a wave case with 3 source frequencies; with
    `jax_statics` each mesh carries the WLSQ stencil and moments the JAX
    package computes (its XLA sums), so that both pools see the same
    statics."""
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    bc = importlib.import_module(f"{pkg}.meshes.bc")
    ns, = cases(pkg, n)
    ns["bc"]["theta_PDE"].update(inlet=[0.5, 0.25, 1.5], mu=[0.05, 0.05, 0.1])
    ns["combos"] = bc.generate_theta_combinations(ns["bc"]["theta_PDE"])
    wave = syn.wave_case(syn.cavity_quad_mesh(n),
                         source_frequency=(1.0, 1.0, 3.0),
                         source_strength=(0.02, 0.02, 0.02), dt=0.05)
    if jax_statics:
        from gen_fvgn_tpu.training.pool import prepare_mesh_statics
        for c, jc in zip((ns, wave), _ns_and_wave(J, n)):
            mesh = prepare_mesh_statics(dict(jc["mesh"]), "2nd")
            c["mesh"] = dict(c["mesh"], **{
                k: np.asarray(mesh[k]) for k in ("stencil", "wlsq_S",
                                                 "wlsq_B", "wlsq_scale")})
    return [ns, wave]


def _pools(seed=3, dataset_size=6):
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    jc, tc = configs("TransFVGN_v2", batch_size=2, dataset_size=dataset_size)
    jpool = JPool([], jc, seed=seed, cases=_ns_and_wave(J),
                  device_resident=True)
    tpool = TPool([], tc, seed=seed, cases=_ns_and_wave(T),
                  engine="segment", device="cpu")
    return jpool, tpool


def _fields(batch):
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(batch)}


def test_pool_batches_match_jax():
    """The same padded sizes, batches from the same permutation, every
    field of a gathered batch equal to the JAX pool's but the WLSQ
    moments, within 1e-5 of their scale (the port sums them in NumPy, JAX
    with XLA, as `load_case` does, tests/test_torch_readers.py; measured
    wlsq_S 8.6e-7, wlsq_scale 1.8e-7, wlsq_B bit-equal), the padding a multiple of 128."""
    jpool, tpool = _pools()
    assert dataclasses.astuple(tpool.sizes) == \
        dataclasses.astuple(jpool.sizes)
    assert tpool.sizes.n_nodes % 128 == 0 and tpool.sizes.n_faces % 128 == 0
    for s in (0, 1, 7):
        jb, tb = jpool.batch_indices(s), tpool.batch_indices(s)
        assert len(jb) == len(tb) == 3
        assert all(np.array_equal(a, b) for a, b in zip(jb, tb))
    idxs = tpool.batch_indices(1)[0]
    jf = _fields(jpool.gather_batch(idxs))
    tf = {k: v.numpy() for k, v in dataclasses.asdict(
        tpool.gather_batch(idxs)).items()}
    assert set(jf) == set(tf)
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        if k.startswith("wlsq_"):
            assert _rel(tf[k], jf[k]) <= 1e-5, k
        else:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def _pay_back_random_states(jpool, tpool, step_seed=1, seed=0):
    rng = np.random.default_rng(seed)
    for idxs in tpool.batch_indices(step_seed):
        uvp = rng.normal(size=(len(idxs), tpool.sizes.n_nodes, 3)
                         ).astype(np.float32)
        jpool.payback(idxs, jnp.asarray(uvp))
        tpool.payback(idxs, torch.from_numpy(uvp))


def test_payback_reroll_and_wave_sources_match_jax():
    """Random states paid back into both pools, then re-rolls around the
    whole age order (the same slot, boundary condition and fields each
    time, the other slots untouched; the WLSQ moments of a re-rolled slot
    as in `test_pool_batches_match_jax`), then the wave sources: the
    pools' states equal to 1e-7 (measured: bit-equal), only the wave
    environments' p channel moved."""
    jpool, tpool = _pools()
    _pay_back_random_states(jpool, tpool)
    assert [e.age for e in tpool.envs] == [e.age for e in jpool.envs]
    drawn = set()
    for _ in range(len(tpool) + 2):
        before = {k: v.clone() for k, v in dataclasses.asdict(
            tpool._tier_data[0]).items()}
        pos = tpool._age_order[0]
        jpool.reset_env()
        tpool.reset_env()
        assert tpool._age_order == jpool._age_order
        jts, tts = jpool.envs[pos].theta_sample, tpool.envs[pos].theta_sample
        assert dataclasses.astuple(jts) == dataclasses.astuple(tts)
        drawn.add(dataclasses.astuple(tts))
        jdata = _fields(jpool._device_data[0])
        for f, now in dataclasses.asdict(tpool._tier_data[0]).items():
            if f.startswith("wlsq_"):
                assert _rel(now.numpy(), jdata[f]) <= 1e-5, f
            else:
                np.testing.assert_array_equal(now.numpy(), jdata[f],
                                              err_msg=f)
            keep = torch.ones(now.shape[0], dtype=torch.bool)
            keep[pos] = False
            assert torch.equal(now[keep], before[f][keep]), f
    assert len(drawn) > 2
    assert tpool.has_wave_envs() and jpool.has_wave_envs()
    before = tpool._tier_data[0].uvp.clone()
    jpool.inject_wave_sources()
    tpool.inject_wave_sources()
    d_t = (tpool._tier_data[0].uvp - before).numpy()
    np.testing.assert_allclose(tpool._tier_data[0].uvp.numpy(),
                               np.asarray(jpool._device_data[0].uvp),
                               rtol=0, atol=1e-7)
    wave = np.asarray([e.theta_sample.source_frequency != 0
                       for e in tpool.envs])
    assert not d_t[..., :2].any() and not d_t[~wave].any()
    assert np.abs(d_t[wave, :, 2]).max() > 1e-3
    for i in (0, 3):
        np.testing.assert_array_equal(tpool.host_uvp(i),
                                      np.asarray(jpool.host_uvp(i)))


def _solve_setup(batch, microbatch=8):
    jc, tc = configs("TransFVGN_v2", batch=batch, microbatch=microbatch)
    jb, tb, nb = batches(6, batch, seed=5)
    tree, apply_fn = segment_params(jc, nb)
    stats = numpy_norm_stats()
    return ((jc, jax.tree_util.tree_map(jnp.asarray, tree),
             jax_norm_state(stats), apply_fn, jb),
            (tc, port_simulator(tc, tree), torch_norm_state(stats), tb))


def test_rollout_three_steps_matches_jax():
    """3 steps of `rollout` from the same state: the four residuals within
    1e-5 relative, the node and cell states within 1e-5 of their scale
    (measured: at most 3.8e-6)."""
    from gen_fvgn_tpu.solve.rollout import rollout as jroll
    from gen_fvgn_tpu_torch.solve.rollout import rollout
    (jc, jp, jn, apply_fn, jb), (tc, sim, tn, tb) = _solve_setup(2)
    jh = jroll(jc, jp, jn, apply_fn, jb, 3)
    th = rollout(tc, sim, tn, tb, 3)
    assert len(th) == len(jh) == 3
    for a, b in zip(jh, th):
        assert set(a) == set(b) and a["step"] == b["step"]
        for k in LOSSES:
            assert b[k].shape == (2,)
            assert _rel(b[k], a[k]) <= 1e-5, k
        for k in ("uvp_node", "uvp_cell"):
            assert b[k].shape == np.asarray(a[k]).shape
            assert _rel(b[k], a[k]) <= 1e-5, k
    assert np.abs(th[2]["uvp_node"] - th[0]["uvp_node"]).max() > 1e-3


@pytest.mark.parametrize("batch,microbatch,chunks,tol", [
    (2, 8, 1, 1e-7), (3, 2, 1, 1e-7), (2, 8, 3, 1e-30), (2, 8, 3, 1e30)],
    ids=["b2", "b3-mb2-chunked", "three-chunks", "stops-after-one-chunk"])
def test_adam_solve_matches_jax(batch, microbatch, chunks, tol):
    """2 time steps at the Config's lr, chunks of 3 inner steps: the inner
    losses within 1e-5 relative, the residuals within 1e-4 and the states
    within 1e-4 of JAX's `solve_adam` (the block solve's limits). With
    `max_chunks_per_step` 3 the solve runs all three chunks under a
    tolerance nothing reaches, and stops after the first under one every
    loss is below. Measured: inner losses ≤ 1.2e-6 relative, residuals
    ≤ 9.0e-6, states ≤ 4.5e-5."""
    from gen_fvgn_tpu.solve.instance_opt import solve_adam as jsolve
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_adam
    (jc, jp, jn, apply_fn, jb), (tc, sim, tn, tb) = _solve_setup(
        batch, microbatch)
    jc, tc = (c.replace(residual_tolerance=tol) for c in (jc, tc))
    _, jh = jsolve(jc, jp, jn, apply_fn, jb, n_time_steps=2, inner_steps=3,
                   max_chunks_per_step=chunks)
    solved, th = solve_adam(tc, sim, tn, tb, n_time_steps=2, inner_steps=3,
                            max_chunks_per_step=chunks, device="cpu")
    assert solved is not sim
    n_inner = 3 * (chunks if tol < 1 else 1)
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        assert t["inner_losses"].shape == np.asarray(
            j["inner_losses"]).shape == (n_inner,)
        assert _rel(t["inner_losses"], j["inner_losses"]) <= 1e-5
        for key in ("loss_cont", "loss_mom_x", "loss_mom_y"):
            assert t[key].shape == (batch,)
            assert _rel(t[key], j[key]) <= 1e-4, key
        for key in ("uvp_node", "uvp_cell"):
            np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-4)


def test_lbfgs_solve_matches_jax():
    """One time step of 5 L-BFGS iterations: the first two iterations'
    values within 1e-5 of JAX's `solve_lbfgs` (the block solve's limit;
    measured 1.9e-6), the value falls."""
    from gen_fvgn_tpu.solve.instance_opt import solve_lbfgs as jsolve
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_lbfgs
    (jc, jp, jn, apply_fn, jb), (tc, sim, tn, tb) = _solve_setup(2)
    _, jh = jsolve(jc, jp, jn, apply_fn, jb, n_time_steps=1, max_iter=5)
    _, th = solve_lbfgs(tc, sim, tn, tb, n_time_steps=1, max_iter=5,
                        device="cpu")
    assert set(th[0]) == set(jh[0])
    tv, jv = th[0]["inner_losses"], np.asarray(jh[0]["inner_losses"])
    assert tv.shape == jv.shape == (5,)
    assert _rel(tv[:2], jv[:2]) <= 1e-5
    assert tv[-1] < tv[0] and np.all(np.isfinite(tv))


def _monitor(run_base):
    path, = glob.glob(os.path.join(run_base, "*", "*", "Loss_monitor.dat"))
    lines = open(path).read().strip().splitlines()
    cols = lines[0].split("=")[1].replace('"', "").split(",")
    rows = np.array([[float(v) for v in line.split(",")]
                     for line in lines[1:]])
    return {c: rows[:, i] for i, c in enumerate(cols)}


@pytest.mark.parametrize("lr,limits", [
    (5e-7, dict(loss=1e-5, loss_cont=1e-5, loss_mom=1e-5, loss_press=1e-4,
                grad_norm=1e-4, state=1e-4)),
    (5e-5, dict(loss=1e-5, loss_cont=1e-3, loss_mom=1e-3, loss_press=1e-3,
                grad_norm=2e-2, state=1e-3))], ids=["lr-5e-7", "config-lr"])
def test_train_three_epochs_matches_jax(tmp_path, monkeypatch, lr, limits):
    """`train()` of the Config's engine (segment), 3 epochs of 2 inner
    steps over an NS and a wave case (4 environments, batch 2), a re-roll
    after every epoch with export on reset, the wave sources. Both sides
    start from the JAX loop's own initialisation (the port's through
    `resume_from`) and see the same WLSQ statics. The lr equal, the same
    re-rolls, ages and exports; per-epoch losses, gradient norms and the
    pools' final states within `limits`.

    At lr 5e-7 the limits of the block loop (tests/test_torch_loop.py),
    but the pressure-outlet loss within 1e-4: weighted 1 against the
    continuity's 6e4 and the momentum's 5e4 it is a small residual
    (0.009-0.028 here) that the step hardly steers, and its relative gap
    grows with the float32 differences of the paid-back states (ROADMAP
    Queue 3). Measured: the loss bit-equal, continuity and momentum ≤ 4.3e-7,
    pressure outlet 3.7e-6, 1.7e-5, 2.2e-5 over the epochs, gradient norms
    3.2e-7, states 5.3e-6. At the Config's lr 5e-5 Adam's first steps are
    sign steps, and elements whose gradient is float32 noise step by ±lr
    (the drift ROADMAP Queue 3 records for the block loop); held to the
    block loop's limits at that lr. Measured: the loss 6.3e-6, its parts
    ≤ 1.0e-4, gradient norms 3.9e-3, states 1.4e-5."""
    from gen_fvgn_tpu.training.loop import train as jtrain
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu.training.train import init_train_state as jinit
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.training.loop import train
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    from gen_fvgn_tpu_torch.training.train import init_train_state
    kw = dict(batch_size=2, dataset_size=4, max_inner_steps=2, n_epochs=3,
              average_sequence_length=4, export_on_reset=True,
              lr=lr)
    jc, tc = configs("TransFVGN_v2", **kw)
    assert jc.engine == tc.engine == "segment"
    jpool = JPool([], jc, seed=0, cases=_ns_and_wave(J), device_resident=True)
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
    jout = jtrain(jc, cases=_ns_and_wave(J), seed=0,
                  log_base_dir=str(tmp_path / "jax"))
    tout = train(tc, cases=_ns_and_wave(T, jax_statics=True), seed=0,
                 log_base_dir=str(tmp_path / "port"), resume_from=start,
                 device="cpu")
    assert int(jout.epoch) == tout.epoch == 3
    assert int(jout.step) == tout.step == 3 * 2 * 2
    jm, tm = _monitor(str(tmp_path / "jax")), _monitor(str(tmp_path / "port"))
    assert set(jm) == set(tm) and len(tm["loss"]) == 3
    np.testing.assert_array_equal(tm["lr"], jm["lr"])
    for key in ("loss", "loss_cont", "loss_mom", "loss_press", "grad_norm"):
        rel = np.abs(tm[key] - jm[key]) / np.maximum(np.abs(jm[key]), 1e-30)
        assert rel.max() <= limits[key], (key, rel)
    (jp,), (tp,) = pools["jax"], pools["port"]
    assert tp._age_order == jp._age_order
    assert [dataclasses.astuple(e.theta_sample) for e in tp.envs] == \
        [dataclasses.astuple(e.theta_sample) for e in jp.envs]
    assert [e.age for e in tp.envs] == [e.age for e in jp.envs]
    gap = np.abs(tp._tier_data[0].uvp.numpy()
                 - np.asarray(jp._device_data[0].uvp)).max()
    assert gap <= limits["state"]
    names = lambda base: sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(base, "*", "*", "traing_results", "*.dat")))
    assert names(str(tmp_path / "port")) == names(str(tmp_path / "jax"))
    assert len(names(str(tmp_path / "port"))) == 2      # epochs 1 and 2
