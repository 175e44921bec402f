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

Cases read from directories and mixed-case batches: `EnvPool(case_dirs)`
against the JAX pool on the same case directories (written by
tools/case_files.py), `mixed_block_batches` against the JAX draw, one
`MixedTrainStepBlock` step against JAX's, a one-group mixed batch against
the single-case step, weight-0 pad rows, and `train(case_dirs=...)` in both
batching modes against the JAX `train()`; each test states its measured
deviations and limits.
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
    dict(engine="segment", bucket_tiers=True), dict(dp_devices=2),
    dict(sp_devices=2),
    dict(node_agg="split"), dict(edge_gather="composed"),
    dict(fv_packed=False)])
def test_train_raises_on_what_is_not_ported(tmp_path, change):
    from gen_fvgn_tpu_torch.training.loop import train
    cfg = _config(T, batch_size=2, dataset_size=2, max_inner_steps=1)
    with pytest.raises(NotImplementedError, match="later slice"):
        train(cfg.replace(**change), cases=_cases(T)[:1],
              log_base_dir=str(tmp_path), n_epochs=1, device="cpu")


# ---- cases read from directories, mixed-case batches ----

def _case_dirs(root):
    """Two case directories written by tools/case_files.py: a
    Navier-Stokes lid-driven quad cavity with 10 boundary conditions (5
    inlet speeds x 2 viscosities) and its pressure pinned at a corner (else
    p is set only up to a constant), and a wave case on a triangle cavity
    with 3 source frequencies."""
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_bc, wave_case)
    from gen_fvgn_tpu_torch.tools.case_files import write_cavity_case
    ns = synthetic_bc(**CASE_KW)
    ns["theta_PDE"].update(inlet=[0.5, 0.25, 1.5], mu=[0.05, 0.05, 0.1])
    wave = wave_case(cavity_quad_mesh(2), source_frequency=(1.0, 1.0, 3.0),
                     source_strength=(0.02, 0.02, 0.02), dt=0.05)["bc"]
    return [write_cavity_case(os.path.join(str(root), "a_ns_quad"), n=5,
                              bc=ns, pressure_point=1),
            write_cavity_case(os.path.join(str(root), "b_wave_tri"), n=4,
                              kind="tri", bc=wave)]


def _dir_pools(dirs, seed=3, **kw):
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    kw = dict(dict(batch_size=4, dataset_size=8), **kw)
    return (JPool(dirs, _config(J, **kw), seed=seed, engine="block"),
            TPool(dirs, _config(T, **kw), seed=seed, device="cpu"))


def test_pool_from_case_dirs_matches_jax(tmp_path):
    """EnvPool(case_dirs): the same cases, environments, boundary
    conditions, samples, device pools and statics as the JAX pool."""
    from test_torch_operators import _dense_of_jax
    jpool, tpool = _dir_pools(_case_dirs(tmp_path))
    assert len(tpool) == len(jpool) == 8
    assert [c["case_name"] for c in tpool.cases] == \
        [c["case_name"] for c in jpool.cases] == ["a_ns_quad", "b_wave_tri"]
    for je, te in zip(jpool.envs, tpool.envs):
        assert te.case_idx == je.case_idx
        assert dataclasses.astuple(te.theta_sample) == \
            dataclasses.astuple(je.theta_sample)
        for f in dataclasses.fields(te.sample):
            got = np.asarray(getattr(te.sample, f.name))
            ref = np.asarray(getattr(je.sample, f.name))
            if f.name.startswith("wlsq"):   # test_torch_readers.py says why
                tol = 1e-5 if f.name == "wlsq_S" else 1e-6
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=tol * np.abs(ref).max())
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f.name)
    assert len({dataclasses.astuple(e.theta_sample) for e in tpool.envs}) > 3
    for ci in range(2):
        for f, v in _port_fields(tpool)[ci].items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(getattr(jpool._dyn_pools[ci], f)))
        for key in ("node|pos", "node|node_type", "cells_node", "cells_face",
                    "face|face_node", "face|neighbour_cell", "face_node_x"):
            np.testing.assert_array_equal(tpool.cases[ci]["mesh"][key],
                                          jpool.cases[ci]["mesh"][key])
        ts, js = tpool.statics[ci], jpool.statics[ci]
        for name in ("pos", "node_type", "node_mask", "cells_area",
                     "edge_pos_feat"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        for name in ("adj", "edge_diff", "wlsq"):
            top = getattr(ts.ops, name).fwd
            ref = _dense_of_jax(getattr(js.ops, name), top.n_in)
            np.testing.assert_allclose(top.to_dense().numpy(), ref,
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("step_seed", [0, 1, 7, 123])
def test_mixed_block_batches_match_jax(tmp_path, step_seed):
    """The same groups, indices, weights and real-row counts as the JAX
    pool's, and their invariants: groups of one case padded to a power of
    two with weight-0 repeats of real rows, real weights summing to 1 over
    a batch, every environment once."""
    jpool, tpool = _dir_pools(_case_dirs(tmp_path), batch_size=3,
                              dataset_size=10)
    got = tpool.mixed_block_batches(step_seed=step_seed)
    ref = jpool.mixed_block_batches(step_seed=step_seed)
    assert len(got) == len(ref) == 3
    seen = []
    for gb, jb in zip(got, ref):
        assert len(gb) == len(jb)
        for (ci, idxs, w, g), (jci, jidxs, jw, jg) in zip(gb, jb):
            assert (ci, g) == (jci, jg)
            np.testing.assert_array_equal(idxs, jidxs)
            np.testing.assert_array_equal(w, jw)
            assert idxs.dtype == jidxs.dtype and w.dtype == jw.dtype
            assert {tpool.envs[int(i)].case_idx for i in idxs} == {ci}
            assert len(idxs) == 1 << (g - 1).bit_length()
            assert set(idxs[g:]) <= set(idxs[:g]) and not w[g:].any()
            seen.extend(idxs[:g])
        assert sum(float(w.sum()) for _, _, w, _ in gb) == \
            pytest.approx(1.0)
    assert len(seen) == len(set(seen)) == 9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_start(jpool, jcfg, ci, idxs):
    from gen_fvgn_tpu.training.train_block import \
        init_train_state_block as jinit
    return jinit(jcfg, jpool.gather_block(idxs), jpool.statics[ci], seed=0)


def _port_from(tcfg, jstate):
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.training.train_block import init_train_state_block
    tstate, sim = init_train_state_block(tcfg, seed=5, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))))
    return tstate, sim


def test_mixed_step_matches_jax(tmp_path):
    """One `MixedTrainStepBlock` step on a batch of two groups (one of them
    padded) from shared weights, against the JAX package's: loss and its
    parts, gradient norm, the summed gradients, parameters, normalizer and
    the paid-back states. Measured (relative norms, limit 5e-6 each): loss
    and parts up to 1.3e-7, gradient norm 6.2e-7, summed gradients 1.4e-6,
    parameters 1.6e-8 (over the elements whose gradient keeps its sign,
    below),
    normalizer 1.0e-7; states within 1e-4 absolute."""
    from gen_fvgn_tpu.training.train_block import \
        MixedTrainStepBlock as JMixed
    from gen_fvgn_tpu_torch.convert import flax_paths
    from gen_fvgn_tpu_torch.training.train_block import MixedTrainStepBlock
    jpool, tpool = _dir_pools(_case_dirs(tmp_path),
                              mixed_case_batches=True)
    jcfg, tcfg = jpool.cfg, tpool.cfg
    step_seed, k = next(
        (s, i) for s in range(20)
        for i, b in enumerate(tpool.mixed_block_batches(step_seed=s))
        if len(b) == 2 and any(len(ix) > g for _, ix, _, g in b))
    batch = tpool.mixed_block_batches(step_seed=step_seed)[k]
    jbatch = jpool.mixed_block_batches(step_seed=step_seed)[k]
    jstate, japply = _jax_start(jpool, jcfg, *jbatch[0][:2])
    tstate, sim = _port_from(tcfg, jstate)

    pay = {"jax": [], "port": []}
    jnew, jm = JMixed(jcfg, japply).run_batch(
        jstate, jbatch, jpool.gather_block, jpool.statics,
        payback=lambda ix, u: pay["jax"].append((ix, np.asarray(u))))
    tnew, tm = MixedTrainStepBlock(tcfg, sim, device="cpu").run_batch(
        tstate, batch, tpool.gather_block, tpool.statics,
        payback=lambda ix, u: pay["port"].append((ix, u.numpy())))
    assert tnew.step == int(jnew.step) == 1
    for name in ("loss", "loss_cont", "loss_mom", "loss_press", "grad_norm"):
        assert _rel(getattr(tm, name), getattr(jm, name)) <= 5e-6, name
    assert tm.lr == float(jm.lr)
    jp = _jax_flat_params(jnew.params)
    tp = flax_paths(dict(sim.named_parameters()))
    assert set(tp) == set(jp)
    # the summed gradients of the step, from the same start on both sides
    jg = _jax_mixed_gradients(JMixed(jcfg, japply), jstate, jbatch, jpool)
    tg = _port_mixed_gradients(MixedTrainStepBlock, tcfg, jstate, batch,
                               tpool)
    flat = lambda d: np.concatenate([d[k].reshape(-1) for k in sorted(jp)])
    assert _rel(flat(tg), flat(jg)) <= 5e-6
    # Adam's first step is close to lr * sign(g): where g is within float32
    # noise of 0 its sign, and so the step, may flip (ROADMAP Queue 3; here
    # four elements, |g| at most 1.0e-5 beside a gradient norm of 4.0e3, one
    # of them, the decoder's p bias, visibly: -1.0e-5 against 5.7e-6). So a
    # sign may differ only where |g| is below 1e-8 of the norm, the
    # parameters are held over the other elements, and every element to
    # one Adam step.
    flip = np.sign(flat(tg)) != np.sign(flat(jg))
    assert (np.abs(flat(jg))[flip] <= 1e-8 * np.linalg.norm(flat(jg))).all()
    assert _rel(flat(tp)[~flip], flat(jp)[~flip]) <= 5e-6
    assert np.abs(flat(tp) - flat(jp)).max() <= 2.2 * tcfg.lr
    for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_acc"):
        assert _rel(getattr(tnew.norm_state, f).numpy(),
                    getattr(jnew.norm_state, f)) <= 5e-6, f
    assert float(tnew.norm_state.num_acc) == 2.0
    assert [ix.tolist() for ix, _ in pay["port"]] == \
        [np.asarray(ix).tolist() for ix, _ in pay["jax"]]
    for (_, u), (_, ju) in zip(pay["port"], pay["jax"]):
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-4)


def _jax_mixed_gradients(jm, jstate, jbatch, jpool):
    """The JAX mixed step's summed gradients, by its own pieces."""
    sums = jm.init_sums()
    for ci, idxs, w, _ in jbatch:
        sums = jm.group_stats(sums, jpool.gather_block(idxs),
                              jpool.statics[ci], jnp.asarray(w))
    norm = jm.norm_update(jstate.norm_state, sums)
    acc = jm.init_acc(jstate.params)
    for ci, idxs, w, _ in jbatch:
        acc, _ = jm.group_grads(jstate.params, norm, acc,
                                jpool.gather_block(idxs), jpool.statics[ci],
                                jnp.asarray(w))
    return _jax_flat_params(acc["gsum"])


def _port_mixed_gradients(cls, tcfg, jstate, batch, tpool):
    """The port's mixed step's summed gradients, by its own pieces, from
    the weights of `jstate`."""
    from gen_fvgn_tpu_torch.convert import flax_paths
    tstate, sim = _port_from(tcfg, jstate)
    mixed = cls(tcfg, sim, device="cpu")
    sums = mixed.init_sums()
    for ci, idxs, w, _ in batch:
        sums = mixed.group_stats(sums, tpool.gather_block(idxs),
                                 tpool.statics[ci], torch.from_numpy(w))
    norm = mixed.norm_update(tstate.norm_state, sums)
    acc = mixed.init_acc()
    for ci, idxs, w, _ in batch:
        acc, _ = mixed.group_grads(norm, acc, tpool.gather_block(idxs),
                                   tpool.statics[ci], torch.from_numpy(w))
    return flax_paths({n: g for (n, _), g in zip(sim.named_parameters(),
                                                 acc["gsum"])})


def _jax_flat_params(params):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(p.key) for p in path)
        out[key[len("params/"):] if key.startswith("params/") else key] = \
            np.asarray(v)
    return out


def _one_case_pool(batch=4):
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = _config(T, batch_size=batch, dataset_size=batch, microbatch=0,
                  mixed_case_batches=True)
    return EnvPool([], cfg, seed=0, cases=_cases(T)[:1], device="cpu")


def test_port_mixed_one_case_batch_is_the_stratified_step():
    """A mixed batch of one group holding a whole single-case batch is the
    single-case train step: the same loss and parts, normalizer, new
    states and parameters. Measured: all equal to the bit (limits 1e-6
    relative, since the hoisted statistics could sum the same rows in
    another order)."""
    import copy

    from gen_fvgn_tpu_torch.training.train_block import (
        MixedTrainStepBlock, init_train_state_block, make_train_step_block)
    pool = _one_case_pool()
    cfg = pool.cfg
    state, sim = init_train_state_block(cfg, seed=0, device="cpu")
    other = copy.deepcopy(state)
    idxs = np.arange(4, dtype=np.int32)
    s_std, m_std, uvp_std = make_train_step_block(cfg, sim, device="cpu")(
        state, pool.gather_block(idxs), pool.statics[0])
    paid = []
    s_mix, m_mix = MixedTrainStepBlock(cfg, other.simulator,
                                       device="cpu").run_batch(
        other, [(0, idxs, np.full(4, 0.25, np.float32), 4)],
        pool.gather_block, pool.statics,
        payback=lambda ix, u: paid.append((ix, u)))
    for name in ("loss", "loss_cont", "loss_mom", "loss_press", "grad_norm"):
        assert _rel(getattr(m_mix, name), getattr(m_std, name)) <= 1e-6, name
    for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_acc"):
        assert _rel(getattr(s_mix.norm_state, f),
                    getattr(s_std.norm_state, f)) <= 1e-6, f
    (ix, u), = paid
    np.testing.assert_array_equal(ix, idxs)
    assert _rel(u, uvp_std) <= 1e-6
    assert _rel(torch.cat([p.detach().reshape(-1)
                           for p in s_mix.simulator.parameters()]),
                torch.cat([p.detach().reshape(-1)
                           for p in s_std.simulator.parameters()])) <= 1e-6
    assert s_mix.step == s_std.step == 1


def test_port_mixed_pad_rows_change_nothing():
    """A group of 3 real rows padded to 4 with a weight-0 repeat gives the
    statistics, weighted loss, loss parts and gradients of the same 3 rows
    unpadded (weights 1/4): the pad row is neither counted by the
    normalizer nor felt by the loss. Measured: statistics and losses equal
    to the bit, gradients 2.4e-7 relative, states 6.1e-9 (limits 1e-6)."""
    from gen_fvgn_tpu_torch.training.train_block import (
        MixedTrainStepBlock, init_train_state_block)
    pool = _one_case_pool()
    cfg = pool.cfg
    _, sim = init_train_state_block(cfg, seed=0, device="cpu")
    mixed = MixedTrainStepBlock(cfg, sim, device="cpu")
    static = pool.statics[0]
    runs = []
    for idxs, w in ((np.asarray([2, 0, 3, 2], np.int32),
                     np.asarray([0.25, 0.25, 0.25, 0.0], np.float32)),
                    (np.asarray([2, 0, 3], np.int32),
                     np.full(3, 0.25, np.float32))):
        dyn, wt = pool.gather_block(idxs), torch.from_numpy(w)
        sums = mixed.group_stats(mixed.init_sums(), dyn, static, wt)
        norm = mixed.norm_update(pool_norm(cfg), sums)
        acc, uvp = mixed.group_grads(norm, mixed.init_acc(), dyn, static, wt)
        runs.append((sums, acc, uvp))
    (s4, a4, u4), (s3, a3, u3) = runs
    for x, y in zip(s4, s3):
        assert _rel(x, y) <= 1e-6
    for name in ("loss", "cont", "mom", "press"):
        assert _rel(a4[name], a3[name]) <= 1e-6, name
    assert _rel(torch.cat([g.reshape(-1) for g in a4["gsum"]]),
                torch.cat([g.reshape(-1) for g in a3["gsum"]])) <= 1e-6
    assert _rel(u4[:3], u3) <= 1e-6


def pool_norm(cfg):
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    return init_normalizer(cfg.node_input_size - cfg.node_phi_size,
                           device="cpu")


def _train_both(tmp_path, mixed, lr):
    """`train(case_dirs=...)` of both packages, 3 epochs of 2 inner steps on
    the two case directories (8 environments, batch 4, a re-roll after
    every epoch, the wave sources), per-case or mixed-case batches, both
    sides from the JAX initialisation (the port's through `resume_from`).
    Returns the two loss monitors, final states and pools."""
    from gen_fvgn_tpu.training.loop import train as jtrain
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.training.loop import train as ttrain
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    dirs = _case_dirs(tmp_path / "data")
    kw = dict(batch_size=4, dataset_size=8, max_inner_steps=2, n_epochs=3,
              average_sequence_length=8, mixed_case_batches=mixed, lr=lr)
    jcfg, tcfg = _config(J, **kw), _config(T, **kw)
    jpool = JPool(dirs, jcfg, seed=0, engine="block")
    ci, idxs = jpool.block_batches(step_seed=0)[0]
    jstate, _ = _jax_start(jpool, jcfg.replace(dataset_size=8), ci, idxs)
    tstate, _ = _port_from(tcfg.replace(dataset_size=8), jstate)
    start = str(tmp_path / "start.state")
    save_state(tstate, start)
    pools = {}
    for name, cls in (("jax", JPool), ("port", TPool)):
        pools[name] = []
        with pytest.MonkeyPatch.context() as mp:
            _capture_pools(mp, cls, pools[name])
            if name == "jax":
                jout = jtrain(jcfg, case_dirs=dirs, seed=0,
                              log_base_dir=str(tmp_path / "jax"))
            else:
                tout = ttrain(tcfg, case_dirs=dirs, seed=0,
                              log_base_dir=str(tmp_path / "port"),
                              resume_from=start, device="cpu")
    assert int(jout.epoch) == tout.epoch == 3
    assert int(jout.step) == tout.step == 3 * 2 * 2
    jm, tm = _monitor(str(tmp_path / "jax")), _monitor(str(tmp_path / "port"))
    assert set(jm) == set(tm) and len(tm["loss"]) == 3
    np.testing.assert_array_equal(tm["lr"], jm["lr"])
    (jp,), (tp,) = pools["jax"], pools["port"]
    assert tp._age_order == jp._age_order
    assert [dataclasses.astuple(e.theta_sample) for e in tp.envs] == \
        [dataclasses.astuple(e.theta_sample) for e in jp.envs]
    assert [e.age for e in tp.envs] == [e.age for e in jp.envs]
    gap = max(float(np.abs(p.uvp.numpy()
                           - np.asarray(jp._dyn_pools[ci].uvp)).max())
              for ci, p in tp._dyn_pools.items())
    return tm, jm, gap


def _monitor_gaps(tm, jm):
    return {key: float((np.abs(tm[key] - jm[key])
                        / np.maximum(np.abs(jm[key]), 1e-30)).max())
            for key in ("loss", "loss_cont", "loss_mom", "loss_press",
                        "grad_norm")}


@pytest.mark.parametrize("mixed", [False, True], ids=["stratified", "mixed"])
def test_train_from_case_dirs_matches_jax(tmp_path, mixed):
    """`_train_both` at lr 5e-7: per-epoch logged losses within 1e-5
    relative, gradient norms 1e-4, pool states 1e-4 (the limits of
    test_train_loop_matches_jax), the same lr, re-rolls and ages.
    Measured {stratified, mixed}: losses {5.3e-7, 1.4e-6}, their parts
    {1.7e-6, 2.0e-7}, gradient norms {1.8e-5, 2.0e-5}, states {1.3e-6,
    1.2e-7}. The learning rate is
    100x under the Config's: there Adam's first steps are sign steps, and
    an element whose gradient is float32 noise around zero steps by +-lr
    on either side, which the next steps feel (ROADMAP Queue 3; bounded by
    test_train_from_case_dirs_at_the_config_lr)."""
    tm, jm, gap = _train_both(tmp_path, mixed, lr=5e-7)
    gaps = _monitor_gaps(tm, jm)
    for key, tol in (("loss", 1e-5), ("loss_cont", 1e-5), ("loss_mom", 1e-5),
                     ("loss_press", 1e-5), ("grad_norm", 1e-4)):
        assert gaps[key] <= tol, (key, gaps[key])
    assert gap <= 1e-4


@pytest.mark.parametrize("mixed", [False, True], ids=["stratified", "mixed"])
def test_train_from_case_dirs_at_the_config_lr(tmp_path, mixed):
    """`_train_both` at the Config's lr 5e-5, where the Adam sign-step
    deviation (above) grows with the lr: measured {stratified, mixed}:
    losses and their parts {3.8e-6, 1.9e-4} relative, gradient norms
    {3.5e-4, 5.6e-3}, pool states {1.3e-4, 1.1e-6}; held to 1e-3, 2e-2
    and 1e-3, limits this test sets from those readings."""
    tm, jm, gap = _train_both(tmp_path, mixed, lr=5e-5)
    gaps = _monitor_gaps(tm, jm)
    assert max(gaps[k] for k in ("loss", "loss_cont", "loss_mom",
                                 "loss_press")) <= 1e-3, gaps
    assert gaps["grad_norm"] <= 2e-2 and gap <= 1e-3, (gaps, gap)
