"""PyTorch port, the training run around the step: the pool's
boundary-condition re-roll (`reset_env_block`) and wave sources
(`inject_wave_sources`) against the JAX pool's, and `train()` against the
JAX package's `train()` over 4 epochs of a Navier-Stokes case and a wave
case with a re-roll every epoch.

Sizes: float32, hidden 32, one message-passing block per processor,
`cavity_quad_mesh(5)`, TransFVGN_v2, the pools' own (bf16-stored)
operators. Measured deviations (the limits in brackets): re-rolled fields
exactly equal (exact); wave signals equal to the last bit (1e-7); per-epoch
logged losses within 7.1e-7 relative and their parts within 5.8e-6
(1e-5), gradient norms within 2.5e-5 relative (1e-4), lr exactly equal;
pool states after the run within 2.4e-6 (1e-4).
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import CASE_KW, _with_outflow, to_plain_dict

J, T = "gen_fvgn_tpu", "gen_fvgn_tpu_torch"


def _cases(pkg, n=5):
    """A Navier-Stokes case with 10 boundary conditions to draw from (5
    inlet speeds x 2 viscosities) and a wave case with 3 source
    frequencies, built by package `pkg`."""
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    bc = importlib.import_module(f"{pkg}.meshes.bc")
    ns = syn.synthetic_case(_with_outflow(syn.cavity_quad_mesh(n)), **CASE_KW)
    ns["bc"]["theta_PDE"].update(inlet=[0.5, 0.25, 1.5], mu=[0.05, 0.05, 0.1])
    ns["combos"] = bc.generate_theta_combinations(ns["bc"]["theta_PDE"])
    wave = syn.wave_case(syn.cavity_quad_mesh(n), source_frequency=(1.0, 1.0,
                                                                    3.0),
                         source_strength=(0.02, 0.02, 0.02), dt=0.05)
    return [ns, wave]


def _config(pkg, **kw):
    import importlib
    cfg = importlib.import_module(f"{pkg}.config").Config
    return cfg(net="TransFVGN_v2", hidden_size=32, message_passing_num=1,
               mxu_dtype="float32", engine="block", **kw)


def _pools(seed=3, dataset_size=6):
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    kw = dict(batch_size=2, dataset_size=dataset_size)
    jpool = JPool([], _config(J, **kw), seed=seed, cases=_cases(J),
                  engine="block")
    tpool = TPool([], _config(T, **kw), seed=seed, cases=_cases(T),
                  device="cpu")
    return jpool, tpool


def _pay_back_random_states(jpool, tpool, step_seed=1, seed=0):
    """The same random new states paid back into both pools (ages move)."""
    rng = np.random.default_rng(seed)
    for _, idxs in tpool.block_batches(step_seed=step_seed):
        n_pad = tpool.gather_block(idxs).uvp.shape[1]
        uvp = rng.normal(size=(len(idxs), n_pad, 3)).astype(np.float32)
        jpool.payback_block(idxs, jnp.asarray(uvp))
        tpool.payback_block(idxs, torch.from_numpy(uvp))


def _port_fields(tpool):
    return {ci: {f.name: getattr(p, f.name).clone()
                 for f in dataclasses.fields(p)}
            for ci, p in tpool._dyn_pools.items()}


def test_reroll_matches_jax():
    """The same seed, cases and payback / re-roll sequence: the same slot
    each time, the same boundary condition, exactly equal re-rolled
    fields, and every other slot of the port's pool untouched."""
    jpool, tpool = _pools()
    _pay_back_random_states(jpool, tpool)
    drawn = set()
    for _ in range(len(tpool) + 2):             # wraps around the age order
        before = _port_fields(tpool)
        pos = tpool._age_order[0]
        jpool.reset_env_block()
        tpool.reset_env_block()
        assert tpool._age_order == jpool._age_order
        assert tpool._age_order[-1] == pos
        jts, tts = jpool.envs[pos].theta_sample, tpool.envs[pos].theta_sample
        assert dataclasses.astuple(jts) == dataclasses.astuple(tts)
        drawn.add(dataclasses.astuple(tts))
        ci, local = tpool.envs[pos].case_idx, tpool._env_local[pos]
        jdyn = jpool._dyn_pools[ci]
        for f, stored in _port_fields(tpool)[ci].items():
            assert np.array_equal(stored[local].numpy(),
                                  np.asarray(getattr(jdyn, f)[local])), f
        for cj, fields in _port_fields(tpool).items():
            for f, now in fields.items():
                keep = torch.ones(now.shape[0], dtype=torch.bool)
                if cj == ci:
                    keep[local] = False
                assert torch.equal(now[keep], before[cj][f][keep]), f
    assert len(drawn) > 2                       # the draws differ


def test_wave_injection_matches_jax(monkeypatch):
    """The same signal as the JAX pool's, to the last bit, only in the wave
    environments' p channel, with one in-place add per case pool that holds
    wave environments."""
    jpool, tpool = _pools()
    _pay_back_random_states(jpool, tpool)
    assert tpool.has_wave_envs() and jpool.has_wave_envs()
    before_t = {ci: p.uvp.clone() for ci, p in tpool._dyn_pools.items()}
    before_j = {ci: np.asarray(p.uvp) for ci, p in jpool._dyn_pools.items()}
    adds = []
    orig = torch.Tensor.index_add_
    monkeypatch.setattr(torch.Tensor, "index_add_",
                        lambda self, *a, **k: adds.append(1)
                        or orig(self, *a, **k))
    jpool.inject_wave_sources()
    tpool.inject_wave_sources()
    wave_cases = {e.case_idx for e in tpool.envs
                  if e.theta_sample.source_frequency != 0}
    assert len(adds) == len(wave_cases) == 1
    for ci, p in tpool._dyn_pools.items():
        d_t = (p.uvp - before_t[ci]).numpy()
        d_j = np.asarray(jpool._dyn_pools[ci].uvp) - before_j[ci]
        np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-7)
        assert not d_t[..., :2].any()
        if ci in wave_cases:
            assert np.abs(d_t[..., 2]).max() > 1e-3
        else:
            assert not d_t.any()


def _monitor(run_base):
    path, = glob.glob(os.path.join(run_base, "*", "*", "Loss_monitor.dat"))
    lines = open(path).read().strip().splitlines()
    cols = lines[0].split("=")[1].replace('"', "").split(",")
    rows = np.array([[float(v) for v in line.split(",")]
                     for line in lines[1:]])
    return {c: rows[:, i] for i, c in enumerate(cols)}


def _capture_pools(monkeypatch, cls, into):
    orig = cls.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        into.append(self)
    monkeypatch.setattr(cls, "__init__", init)


def test_train_loop_matches_jax(tmp_path, monkeypatch):
    """4 epochs, 2 inner steps, an NS and a wave case of 2 environments
    each, batch 2, a re-roll after every epoch with export on reset. Both
    sides start from the JAX initialisation; the port takes it through
    `resume_from` of a checkpoint made from it."""
    from gen_fvgn_tpu.training.loop import train as jtrain
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu.training.train_block import \
        init_train_state_block as jinit
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.training.loop import train as ttrain
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    from gen_fvgn_tpu_torch.training.train_block import init_train_state_block
    kw = dict(batch_size=2, dataset_size=4, max_inner_steps=2, n_epochs=4,
              average_sequence_length=4, export_on_reset=True)
    jcfg, tcfg = _config(J, **kw), _config(T, **kw)

    # the JAX loop's own initialisation, made the way _train_block makes it
    jpool = JPool([], jcfg, seed=0, cases=_cases(J), engine="block")
    ci, idxs = jpool.block_batches(step_seed=0)[0]
    jstate, _ = jinit(jcfg.replace(dataset_size=len(jpool)),
                      jpool.gather_block(idxs), jpool.statics[ci], seed=0)
    tstate, sim = init_train_state_block(tcfg.replace(dataset_size=4),
                                         seed=5, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))))
    start = str(tmp_path / "start.state")
    save_state(tstate, start)

    pools = {}
    for name, cls in (("jax", JPool), ("port", TPool)):
        pools[name] = []
        _capture_pools(monkeypatch, cls, pools[name])
    jout = jtrain(jcfg, cases=_cases(J), log_base_dir=str(tmp_path / "jax"),
                  seed=0, n_epochs=4)
    tout = ttrain(tcfg, cases=_cases(T), log_base_dir=str(tmp_path / "port"),
                  seed=0, n_epochs=4, resume_from=start, device="cpu")
    assert int(jout.epoch) == tout.epoch == 4
    assert int(jout.step) == tout.step == 16

    jm, tm = _monitor(str(tmp_path / "jax")), _monitor(str(tmp_path / "port"))
    assert set(jm) == set(tm) and len(tm["loss"]) == 4
    np.testing.assert_array_equal(tm["step"], np.arange(4))
    np.testing.assert_array_equal(tm["lr"], jm["lr"])
    assert len(set(tm["lr"])) > 1               # the schedule moved
    for key, tol in (("loss", 1e-5), ("loss_cont", 1e-5), ("loss_mom", 1e-5),
                     ("loss_press", 1e-5), ("grad_norm", 1e-4)):
        rel = np.abs(tm[key] - jm[key]) / np.maximum(np.abs(jm[key]), 1e-30)
        assert rel.max() <= tol, (key, rel.max())

    (jp,), (tp,) = pools["jax"][-1:], pools["port"][-1:]
    assert tp._age_order == jp._age_order
    assert [e.age for e in tp.envs] == [e.age for e in jp.envs]
    for ci, p in tp._dyn_pools.items():
        np.testing.assert_allclose(p.uvp.numpy(),
                                   np.asarray(jp._dyn_pools[ci].uvp),
                                   rtol=0, atol=1e-4)
    names = lambda base: sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(base, "*", "*", "traing_results", "*.dat")))
    assert names(str(tmp_path / "port")) == names(str(tmp_path / "jax"))
    assert len(names(str(tmp_path / "port"))) == 3      # epochs 1, 2, 3


@pytest.mark.parametrize("change", [
    dict(engine="segment"), dict(dp_devices=2), dict(sp_devices=2),
    dict(mixed_case_batches=True), "case_dirs", "tensorboard"])
def test_train_raises_on_what_is_not_ported(tmp_path, change):
    from gen_fvgn_tpu_torch.training.loop import train
    cfg = _config(T, batch_size=2, dataset_size=2, max_inner_steps=1)
    kw = dict(cases=_cases(T)[:1], log_base_dir=str(tmp_path), n_epochs=1,
              device="cpu")
    if change == "case_dirs":
        kw["case_dirs"] = ["some_case"]
    elif change == "tensorboard":
        kw["use_tensorboard"] = True
    else:
        cfg = cfg.replace(**change)
    with pytest.raises(NotImplementedError, match="later slice"):
        train(cfg, **kw)
