"""PyTorch port, the training loop's pieces: `make_train_step_block`
against the JAX package's step over 1 and 10 steps from the same start,
the chunked step against the unchunked one, and the pool's
`block_batches` / `payback_block`.

Trajectory (TransFVGN_v2, float32, hidden 32, structural operators stored
float32 on both sides, the Config's lr 5e-5): each step's loss within 1e-5
relative and its gradient norm within 1e-4 relative; the new state within
1e-4; the parameters' total change within 2e-2 of its norm after step 1
and after step 10. Adam divides each gradient element by its own running
size (its first step is lr·g/(|g| + 1e-8)), so an element whose gradient
is near 1e-8 moves by up to a full step on a last-bit difference of g: the
parameters part faster than the losses. The test shows that this is the
cause: over the elements whose gradient stayed at or above 1e-6 (100 times
Adam's eps) at every step so far, the change agrees within 1e-4.
Measured: parameter change 9.4e-3 after step 1 and 4.6e-3 after step 10;
the elements that were ever below 1e-6 are 6.5% and 7.6% of all, and
without them the change agrees within 1.2e-5 and 4.6e-5; losses within
4e-7 relative, gradient norms within 1e-5, states within 1.1e-5.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, f32_operator_statics, jax_flat,
                               jax_norm_state, numpy_norm_stats,
                               numpy_params, port_flat, random_state,
                               torch_norm_state, torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

F32 = (6, 32, 1, "float32", 2)
NEAR_EPS = 1e-6     # a gradient element this small moves on Adam's eps
NORM_FIELDS = ("acc_sum", "acc_sum_sq", "acc_count", "num_acc")


def _port_params(sim):
    return port_flat(dict(sim.named_parameters()))


def _change_gap(p_port, p_jax, p0, keep=None):
    """‖(port − start) − (jax − start)‖ / ‖jax − start‖, over every element
    or over those that `keep` ({path: bool array}) marks."""
    keep = keep or {k: np.ones(v.shape, bool) for k, v in p0.items()}
    num = sum(((p_port[k] - p_jax[k])[keep[k]] ** 2).sum() for k in p0)
    den = sum(((p_jax[k] - p0[k])[keep[k]] ** 2).sum() for k in p0)
    return float(np.sqrt(num / den))


def _port_state(tc, sim, stats):
    from gen_fvgn_tpu_torch.training.train import TrainState, make_optimizer
    return TrainState(simulator=sim,
                      optimizer=make_optimizer(tc, sim.parameters()),
                      norm_state=torch_norm_state(stats))


def test_train_steps_match_jax_over_1_and_10_steps():
    from gen_fvgn_tpu.training.train import TrainState, _make_optimizer
    from gen_fvgn_tpu.training.train_block import \
        make_train_step_block as jmake
    from gen_fvgn_tpu_torch.training.train_block import \
        make_train_step_block as tmake
    net = "TransFVGN_v2"
    (jc, _, _, jd), (tc, _, _, td) = both_sides(*F32, net=net)
    js, ts = f32_operator_statics(*F32, net=net)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd, td = random_state(jd, td, np.asarray(js.node_mask), seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = TrainState(params=jparams,
                        opt_state=_make_optimizer(jc).init(jparams),
                        norm_state=jax_norm_state(stats),
                        step=jnp.asarray(0, jnp.int32),
                        epoch=jnp.asarray(0, jnp.int32))
    jstep = jmake(jc, apply_fn, donate=False)
    sim = torch_simulator(tc, tree)
    tstate = _port_state(tc, sim, stats)
    tstep = tmake(tc, sim, device="cpu")
    p0 = jax_flat(jparams)
    real = np.asarray(js.node_mask)
    mu_prev = {key: np.zeros_like(v) for key, v in p0.items()}
    g_min = None
    for k in range(10):
        jstate, jm, juvp = jstep(jstate, jd, js)
        tstate, tm, tuvp = tstep(tstate, td, ts)
        # this step's |gradient| per element, from the JAX Adam's first
        # moment (mu = 0.9 mu_prev + 0.1 g), and its least value so far
        mu = jax_flat(jstate.opt_state.inner_state[0].mu)
        g = {key: np.abs(mu[key] - 0.9 * mu_prev[key]) / 0.1 for key in p0}
        g_min = g if g_min is None else {
            key: np.minimum(g_min[key], g[key]) for key in p0}
        mu_prev = mu
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(float(tm.grad_norm), float(jm.grad_norm),
                                   rtol=1e-4)
        for name in ("loss_cont", "loss_mom", "loss_press"):
            np.testing.assert_allclose(float(getattr(tm, name)),
                                       float(getattr(jm, name)), rtol=1e-4)
        assert tm.lr == float(jm.lr)
        np.testing.assert_allclose(tuvp.numpy()[:, real],
                                   np.asarray(juvp)[:, real], atol=1e-4)
        if k in (0, 9):
            p_port, p_jax = _port_params(sim), jax_flat(jstate.params)
            gap = _change_gap(p_port, p_jax, p0)
            away = {key: g_min[key] >= NEAR_EPS for key in p0}
            gap_away = _change_gap(p_port, p_jax, p0, away)
            assert gap < 2e-2 and gap_away < 1e-4, (k, gap, gap_away)
        jd, td = jd.replace(uvp=juvp), td.replace(uvp=tuvp)
    assert tstate.step == int(jstate.step) == 10
    for name in NORM_FIELDS:
        np.testing.assert_allclose(getattr(tstate.norm_state, name).numpy(),
                                   np.asarray(getattr(jstate.norm_state,
                                                      name)), rtol=1e-6)


def test_chunked_step_matches_the_unchunked_step():
    """Batch 4 in 2 chunks of 2 (cfg.microbatch 2) against one unchunked
    step of the same batch (microbatch 4): same loss, gradient norm, new
    states and normalizer up to float32 summation order; parameters within
    1e-6, 2% of one Adam step at lr 5e-5 (an element whose gradient is
    near Adam's eps moves by a part of a step on a last-bit difference;
    measured 6.7e-8)."""
    from unittest import mock

    from gen_fvgn_tpu_torch.training import train_block as tb
    net = "TransFVGN_v2"
    args = (6, 32, 1, "float32", 4)
    (jc, _, _, jd), (tc, _, _, td) = both_sides(*args, net=net)
    js, ts = f32_operator_statics(*args, net=net)
    tree, _ = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    _, td = random_state(jd, td, np.asarray(js.node_mask), seed=7)
    results = []
    for mb, calls in ((2, 2), (4, 1)):
        cfg = tc.replace(microbatch=mb)
        sim = torch_simulator(cfg, tree)
        state = _port_state(cfg, sim, stats)
        with mock.patch.object(tb, "forward_batch_block",
                               wraps=tb.forward_batch_block) as fwd:
            state, m, uvp = tb.make_train_step_block(cfg, sim, device="cpu")(
                state, td, ts)
        assert fwd.call_count == calls
        assert [c.args[2].uvp.shape[0] for c in fwd.call_args_list] == \
            [4 // calls] * calls
        results.append((m, uvp, state.norm_state, _port_params(sim)))
    (m2, u2, n2, p2), (m1, u1, n1, p1) = results
    np.testing.assert_allclose(float(m2.loss), float(m1.loss), rtol=1e-6)
    np.testing.assert_allclose(float(m2.grad_norm), float(m1.grad_norm),
                               rtol=1e-5)
    np.testing.assert_allclose(u2.numpy(), u1.numpy(), atol=1e-6)
    for name in NORM_FIELDS:
        np.testing.assert_allclose(getattr(n2, name).numpy(),
                                   getattr(n1, name).numpy(), rtol=1e-6)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=0, atol=1e-6)


def test_block_batches_match_the_jax_pool():
    (_, jp, _, _), (_, tp, _, _) = both_sides(6, 32, 1, "float32", 2)
    for seed in (0, 3, 11):
        jb, tb = jp.block_batches(seed), tp.block_batches(seed)
        assert [c for c, _ in tb] == [c for c, _ in jb]
        for (_, a), (_, b) in zip(tb, jb):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_payback_block_writes_only_the_rows_it_names():
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net="FVGN", batch_size=2, dataset_size=4, hidden_size=32)
    case = synthetic_case(cavity_quad_mesh(4), continuity=1, convection=1,
                          grad_p=1, mu=0.05, sigma=(1, 1, 1))
    pool = EnvPool([], cfg, cases=[case], device="cpu")
    assert len(pool.envs) == 4
    before = pool.gather_block(np.arange(4)).uvp.clone()
    ages = [e.age for e in pool.envs]
    idxs = np.asarray([3, 1], np.int32)
    new = torch.randn(2, before.shape[1], 3, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    new.requires_grad_()
    pool.payback_block(idxs, new)
    after = pool.gather_block(np.arange(4)).uvp
    assert after.dtype == before.dtype
    assert torch.equal(after[3], new[0].detach().to(after.dtype))
    assert torch.equal(after[1], new[1].detach().to(after.dtype))
    assert torch.equal(after[0], before[0]) and torch.equal(after[2],
                                                            before[2])
    assert [e.age for e in pool.envs] == [ages[0], ages[1] + 1, ages[2],
                                          ages[3] + 1]
    # the other fields of the pool stay as they were
    again = pool.gather_block(np.asarray([1, 3]))
    assert torch.equal(again.uvp, torch.stack([after[1], after[3]]))
