"""PyTorch port, the instance-optimisation solves: the chunked gradient
against the unchunked one, `solve_adam_block` and `solve_lbfgs_block`
against the JAX package's, and the port's L-BFGS (solve/lbfgs.py) against
`optax.lbfgs` itself.

Sizes: float32, hidden 32, one message-passing block per processor,
TransFVGN_v2, `cavity_quad_mesh(6)`, the structural operators stored
float32 on both sides (a bf16-stored operator would let a last-bit
difference flip a rounding, see tests/torch_port_common.py), weights and
normalizer statistics from NumPy seeds, a random state. Measured (limits
in brackets): chunked gradient against the unchunked one 1.1e-7 relative
in norm (1e-5), loss equal (1e-6 relative); Adam solve at the Config's lr
(5e-5) inner losses within 3.1e-7 relative unchunked and chunked (1e-5),
residuals within 5.2e-6 relative (1e-4), states within 7.9e-6 and 7.6e-6
(1e-4); L-BFGS solve, the first two iterations' values within 2.9e-6
relative (1e-5); the port's L-BFGS against optax.lbfgs in float64,
iterates within 1.9e-12 over 20 iterations (1e-9).

At twice that lr (1e-4) the solve is held one time step at a time. A fresh
Adam's first steps are close to sign steps (lr·g/(|g| + 1e-8)), so an
element whose gradient lies within float32's summation error of zero moves
by a whole step on a last-bit difference, the deviation
tests/test_torch_train_loop.py measures for the train step. From a shared
start each time step agrees: inner losses within 1.5e-7 and 3.2e-7
relative (1e-5), residuals within 7.7e-6 and 1.0e-5 (1e-4), states within
1.4e-5 and 1.0e-5 (1e-4), and the parameters' change within 2.3e-5 and
2.1e-5 of its norm (1e-4) over the elements whose gradient stayed at or
above 1e-5 at every inner step, 91% of all (9.8e-5 and 1.1e-4 with 1e-6
as the cut: here an element whose gradient is 5.3e-6 flips sign).
Chained, the second time step starts from parameters that already differ
in those elements: its inner losses stay within 7.9e-7 relative (1e-5),
but it ends 1.9e-4 from JAX's state (1e-3), its residuals within 8.2e-5
relative (1e-3).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_common import (both_sides, f32_operator_statics, jax_flat,
                               jax_norm_state, numpy_norm_stats,
                               numpy_params, port_flat, random_state,
                               torch_norm_state, torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

NET = "TransFVGN_v2"
NEAR_ZERO = 1e-5    # a gradient element this small may flip sign at lr 1e-4


def _setup(batch, microbatch=8, seed=5):
    """JAX and port sides of one solve: (cfg, params, norm_state, apply,
    dyn, static) and (cfg, simulator, norm_state, dyn, static)."""
    shape = (6, 32, 1, "float32", batch)
    (jc, _, _, jd), (tc, _, _, td) = both_sides(*shape, net=NET)
    js, ts = f32_operator_statics(*shape, net=NET)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd, td = random_state(jd, td, np.asarray(js.node_mask), seed=seed)
    jc, tc = jc.replace(microbatch=microbatch), tc.replace(
        microbatch=microbatch)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return ((jc, jparams, jax_norm_state(stats), apply_fn, jd, js),
            (tc, torch_simulator(tc, tree), torch_norm_state(stats), td, ts))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_chunked_value_and_grad_matches_the_unchunked_gradient():
    """Batch 3 in chunks of 2 (one pad row, weight 0) against the whole
    batch's mean loss and gradient."""
    from gen_fvgn_tpu_torch.solve.instance_opt import _Problem
    _, (tc, sim, norm, td, ts) = _setup(3, microbatch=2)
    chunked = _Problem(tc, sim, norm, td, ts)
    whole = _Problem(tc.replace(microbatch=0), sim, norm, td, ts)
    assert chunked.chunked and not whole.chunked
    lc, gc = chunked.value_and_grad()
    lw, gw = whole.value_and_grad()
    num = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(gc, gw)))
    den = torch.sqrt(sum((b ** 2).sum() for b in gw))
    assert float(num / den) <= 1e-5
    assert abs(float(lc - lw)) <= 1e-6 * abs(float(lw))
    from gen_fvgn_tpu_torch.training.chunking import (chunk_plan,
                                                      mean_weights, pad_rows)
    assert chunk_plan(3, 2) == (2, 1) and chunk_plan(4, 2) == (2, 0)
    third = float(np.float32(1 / 3))
    assert mean_weights(3, 1).tolist() == [third, third, third, 0.0]
    padded = pad_rows(td, 1)
    assert torch.equal(padded.uvp[3], td.uvp[0]) and padded.dt.shape == (4,)


@pytest.mark.parametrize("batch,microbatch", [(2, 8), (3, 2)],
                         ids=["b2", "b3-mb2-chunked"])
def test_adam_solve_matches_jax(batch, microbatch):
    """2 time steps x 3 inner steps at the Config's lr (5e-5, the solve's
    default): inner losses, the residuals and the new states of each time
    step against `solve_adam_block`; the caller's simulator is left as it
    was."""
    from gen_fvgn_tpu.solve.instance_opt import solve_adam_block as jsolve
    from gen_fvgn_tpu_torch.solve.instance_opt import \
        solve_adam_block as tsolve
    (jc, jp, jn, apply_fn, jd, js), (tc, sim, tn, td, ts) = _setup(
        batch, microbatch)
    before = copy.deepcopy(sim.state_dict())
    _, jh = jsolve(jc, jp, jn, apply_fn, jd, js, n_time_steps=2,
                   inner_steps=3)
    solved, th = tsolve(tc, sim, tn, td, ts, n_time_steps=2, inner_steps=3,
                        device="cpu")
    assert solved is not sim
    for k, v in sim.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not all(torch.equal(v, before[k])
                   for k, v in solved.state_dict().items())
    assert len(th) == 2
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        assert t["inner_losses"].shape == (3,)
        assert _rel(t["inner_losses"], j["inner_losses"]) <= 1e-5
        for key in ("loss_cont", "loss_mom_x", "loss_mom_y"):
            assert t[key].shape == (batch,)
            assert _rel(t[key], j[key]) <= 1e-4, key
        for key in ("uvp_node", "uvp_cell"):
            assert t[key].shape == np.asarray(j[key]).shape
            np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-4)
    assert not np.array_equal(th[0]["uvp_node"], th[1]["uvp_node"])


def _least_port_gradients(monkeypatch):
    """{flax path: least |gradient| per element} over the port solve's inner
    steps since the dict was last cleared."""
    from gen_fvgn_tpu_torch.solve.instance_opt import _Problem
    g_min = {}
    inner = _Problem.value_and_grad

    def value_and_grad(self):
        loss, grads = inner(self)
        for (name, _), g in zip(self.sim.named_parameters(), grads):
            a = g.detach().abs().numpy().astype(np.float64)
            key = name.replace(".", "/")
            g_min[key] = np.minimum(g_min[key], a) if key in g_min else a
        return loss, grads
    monkeypatch.setattr(_Problem, "value_and_grad", value_and_grad)
    return g_min


def _hold_time_step(t, j, state_atol, residual_rtol):
    assert _rel(t["inner_losses"], j["inner_losses"]) <= 1e-5
    for key in ("loss_cont", "loss_mom_x", "loss_mom_y"):
        assert _rel(t[key], j[key]) <= residual_rtol, key
    for key in ("uvp_node", "uvp_cell"):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=state_atol)


def test_adam_solve_at_lr_1e_4_matches_jax_each_time_step(monkeypatch):
    """Batch 2, 2 time steps x 3 inner steps at lr 1e-4, one time step at a
    time: time step 1 from the common start, time step 2 from JAX's end of
    time step 1 on both sides, each held to the limits of the lr 5e-5 test
    and with the parameters' change over the elements whose gradient stayed
    at or above NEAR_ZERO within 1e-4; then the port's time step 2 from its
    own end of time step 1 (the chained solve) against JAX's."""
    from gen_fvgn_tpu.solve.instance_opt import solve_adam_block as jsolve
    from gen_fvgn_tpu_torch.solve.instance_opt import \
        solve_adam_block as tsolve
    (jc, jp, jn, apply_fn, jd, js), (tc, sim, tn, td, ts) = _setup(2)
    g_min = _least_port_gradients(monkeypatch)
    kw = dict(n_time_steps=1, inner_steps=3, lr=1e-4)

    def both(jparams, jdyn, tsim, tdyn):
        p0 = jax_flat(jparams)
        g_min.clear()
        jout, (jh,) = jsolve(jc, jparams, jn, apply_fn, jdyn, js, **kw)
        tout, (th,) = tsolve(tc, tsim, tn, tdyn, ts, device="cpu", **kw)
        _hold_time_step(th, jh, 1e-4, 1e-4)
        pp, pj = port_flat(dict(tout.named_parameters())), jax_flat(jout)
        away = {k: g_min[k] >= NEAR_ZERO for k in p0}
        num = sum(((pp[k] - pj[k])[away[k]] ** 2).sum() for k in p0)
        den = sum(((pj[k] - p0[k])[away[k]] ** 2).sum() for k in p0)
        assert np.sqrt(num / den) < 1e-4
        return (jout, jdyn.replace(uvp=jnp.asarray(jh["uvp_node"])), jh), \
            (tout, tdyn.replace(uvp=torch.from_numpy(th["uvp_node"])))

    (jp1, jd1, _), (sim1, td1) = both(jp, jd, sim, td)
    (_, _, jh2), _ = both(jp1, jd1,
                          torch_simulator(tc, jax.tree_util.tree_map(
                              np.asarray, jp1)),
                          td.replace(uvp=torch.from_numpy(
                              np.asarray(jd1.uvp).copy())))
    _, (chained,) = tsolve(tc, sim1, tn, td1, ts, device="cpu", **kw)
    _hold_time_step(chained, jh2, 1e-3, 1e-3)


def test_lbfgs_solve_matches_jax():
    """One time step of 5 L-BFGS iterations (memory 100): the first two
    iterations' values against `solve_lbfgs_block`, and the residual falls."""
    from gen_fvgn_tpu.solve.instance_opt import solve_lbfgs_block as jsolve
    from gen_fvgn_tpu_torch.solve.instance_opt import \
        solve_lbfgs_block as tsolve
    (jc, jp, jn, apply_fn, jd, js), (tc, sim, tn, td, ts) = _setup(2)
    _, jh = jsolve(jc, jp, jn, apply_fn, jd, js, n_time_steps=1, max_iter=5)
    _, th = tsolve(tc, sim, tn, td, ts, n_time_steps=1, max_iter=5,
                   device="cpu")
    assert set(th[0]) == set(jh[0])
    tv, jv = th[0]["inner_losses"], np.asarray(jh[0]["inner_losses"])
    assert tv.shape == jv.shape == (5,)
    assert _rel(tv[:2], jv[:2]) <= 1e-5
    assert tv[-1] < tv[0] and np.all(np.isfinite(tv))
    assert th[0]["uvp_node"].shape == np.asarray(jh[0]["uvp_node"]).shape


def _rosenbrock(xp):
    return lambda x: xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                            + (1 - x[:-1]) ** 2)


def _quadratic(xp, to):
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(10, 10)))
    a = to(q @ np.diag(np.logspace(0, 2, 10)) @ q.T)
    b = to(rng.normal(size=10))
    return lambda x: 0.5 * x @ (a @ x) - b @ x


@pytest.mark.parametrize("memory", [5, 100])
@pytest.mark.parametrize("problem", ["rosenbrock", "quadratic"])
def test_lbfgs_follows_optax_in_float64(problem, memory, monkeypatch):
    """20 iterations from the same start (Rosenbrock's far from its
    minimum, so that the line search zooms): every iterate and value within
    1e-9 of optax.lbfgs's. With memory 5 the ring of pairs wraps."""
    from gen_fvgn_tpu_torch.solve import lbfgs
    zooms = []
    zoom = lbfgs._Search._zoom
    monkeypatch.setattr(lbfgs._Search, "_zoom",
                        lambda self: zooms.append(1) or zoom(self))
    x0 = np.random.default_rng(1).uniform(-3, 3, size=10)
    with jax.enable_x64(True):
        if problem == "rosenbrock":
            fj, ft = _rosenbrock(jnp), _rosenbrock(torch)
        else:
            fj = _quadratic(jnp, jnp.asarray)
            ft = _quadratic(torch, torch.from_numpy)
        opt = optax.lbfgs(memory_size=memory)
        vg = optax.value_and_grad_from_state(fj)

        @jax.jit
        def step(x, st):
            v, g = vg(x, state=st)
            u, st = opt.update(g, st, x, value=v, grad=g, value_fn=fj)
            return optax.apply_updates(x, u), st, v
        x = jnp.asarray(x0, jnp.float64)
        st = opt.init(x)
        ref = []
        for _ in range(20):
            x, st, v = step(x, st)
            ref.append((np.asarray(x), float(v)))

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = ft(x)
            g, = torch.autograd.grad(v, x)
        return v.detach(), g
    mine = lbfgs.LBFGS(torch.from_numpy(x0.copy()), memory_size=memory)
    evaluations = []
    for xr, vr in ref:
        v = mine.step(value_and_grad)
        evaluations.append(mine.evaluations)
        assert mine.x.dtype == torch.float64
        np.testing.assert_allclose(mine.x.numpy(), xr, rtol=0, atol=1e-9)
        assert abs(float(v) - vr) <= 1e-9 * max(1.0, abs(vr))
    assert evaluations[0] == 2 and ref[-1][1] < ref[0][1]
    if problem == "rosenbrock":
        assert zooms                        # the line search zoomed
