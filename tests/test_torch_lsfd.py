"""PyTorch port, the least-squares finite-difference (LSFD) residual and the
full folded WLSQ rows it reads, against the JAX package on the same small
synthetic cavity and NumPy states (float32).

  * The folded WLSQ operator with all k rows (wlsq_block_rows="full") at
    2nd and 3rd order: its apply to the same fields within 1e-5 of the
    output's scale. At 2nd order each package builds it in its own pool
    from its own mesh and WLSQ moments (measured 2.0e-6). At 3rd order
    both fold the JAX pool's mesh and moments (measured 1.4e-7): with
    each package's own moments (float32 sums in another order, within
    1.9e-6 of their scale) a corner node whose 9-unknown system is
    singular (condition 1e50 before the 1e-6 ridge) turns a 1e-7
    difference of its moments into 0.8% of wlsq_S, so the moments are
    taken from one package.
  * `lsfd_residual_block` (2nd and 3rd order) and `lsfd_residual` (the
    segment engine, on the JAX batch's own statics): the raw residual
    within 1e-5 relative (measured 1.2e-7), the normalized one of the
    first call equal to 1, and with the first call's raw residual passed
    back, within 1e-5 (1.2e-7); the block residual's gradient with respect
    to the state within 1e-4 of its norm (measured 1.1e-7 and 1.4e-7).
  * The refusals: order "1st" (no Hessian) in both functions, and the
    block function on a pack of gradient rows only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_segment import batches
from torch_port_common import CASE_KW, _with_outflow, random_state
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)


def _block_pools(order, rows="full", n=6, batch=2):
    """The JAX and the port's block pools of the outflow cavity at `order`,
    the WLSQ operator folded with `rows`; (jstatic, jdyn, tstatic, tdyn)
    with the same random state. The port's StaticPack is its pool's own at
    2nd order, and at 3rd built from the JAX pool's mesh and WLSQ moments
    (see the module's docstring)."""
    from gen_fvgn_tpu_torch.graph.packs import build_static_pack
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.meshes.synthetic import cavity_quad_mesh as jmesh
    from gen_fvgn_tpu.meshes.synthetic import synthetic_case as jcase
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.config import Config as TConfig
    from gen_fvgn_tpu_torch.meshes.synthetic import \
        cavity_quad_mesh as tmesh
    from gen_fvgn_tpu_torch.meshes.synthetic import \
        synthetic_case as tcase
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    kw = dict(net="FVGN", batch_size=batch, dataset_size=batch,
              mxu_dtype="float32", hidden_size=32, message_passing_num=1,
              engine="block", order=order, wlsq_block_rows=rows)
    jp = JPool([], JConfig(**kw), seed=0, engine="block",
               cases=[jcase(_with_outflow(jmesh(n)), **CASE_KW)])
    tp = TPool([], TConfig(**kw), seed=0, device="cpu",
               cases=[tcase(_with_outflow(tmesh(n)), **CASE_KW)])
    jd, td = jp.gather_block(np.arange(batch)), tp.gather_block(
        np.arange(batch))
    jd, td = random_state(jd, td, np.asarray(jp.statics[0].node_mask), 4)
    if order == "2nd":
        return jp.statics[0], jd, tp.statics[0], td
    mesh = {k: np.asarray(v) for k, v in jp.cases[0]["mesh"].items()}
    ts = build_static_pack(mesh, order, tp.case_sizes[0], wlsq_rows=rows,
                           node_agg="composed", device="cpu")
    return jp.statics[0], jd, ts, td


def _hat(uvp, seed=9):
    """A second velocity field, uv_hat, from a NumPy seed (masked as uvp)."""
    rng = np.random.default_rng(seed)
    mask = (np.abs(uvp).sum(-1, keepdims=True) > 0)
    return (rng.normal(size=uvp.shape[:-1] + (2,)) * mask).astype(np.float32)


@pytest.mark.parametrize("order", ["2nd", "3rd"])
def test_full_folded_wlsq_rows_match_jax(order):
    from gen_fvgn_tpu.ops.blocksparse import apply_linop as japply
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop as tapply
    from gen_fvgn_tpu_torch.ops.wlsq import WLSQ_DIM
    js, _, ts, _ = _block_pools(order)
    k = WLSQ_DIM[order]
    assert ts.ops.wlsq_n_q == js.ops.wlsq_n_q == k
    n = ts.pos.shape[0]
    x = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    x *= ts.node_mask.numpy()[:, None]
    ref = np.asarray(japply(js.ops.wlsq, jnp.asarray(x)))[: n * k]
    got = tapply(ts.ops.wlsq, torch.from_numpy(x)).numpy()[: n * k]
    assert got.shape == ref.shape == (n * k, 3)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("order", ["2nd", "3rd"])
def test_lsfd_residual_block_matches_jax(order):
    from gen_fvgn_tpu.fv.lsfd import lsfd_residual_block as jlsfd
    from gen_fvgn_tpu_torch.fv.lsfd import lsfd_residual_block as tlsfd
    js, jd, ts, td = _block_pools(order)
    uvp = np.asarray(jd.uvp)
    hat = _hat(uvp)

    def jloss(u, h, init=None):
        return jlsfd(u, h, jd, js, order=order, init_residual=init)
    j1, jraw = jloss(jnp.asarray(uvp), jnp.asarray(hat))
    u_t = torch.from_numpy(uvp.copy()).requires_grad_(True)
    t1, traw = tlsfd(u_t, torch.from_numpy(hat), td, ts, order=order)
    assert t1.shape == traw.shape == (2,)
    np.testing.assert_allclose(traw.detach().numpy(), np.asarray(jraw),
                               rtol=1e-5)
    np.testing.assert_allclose(t1.detach().numpy(), 1.0, rtol=1e-6)
    # later calls, normalized by the first call's raw residual
    scaled = 0.5 * uvp
    j2, _ = jloss(jnp.asarray(scaled), jnp.asarray(hat), jraw)
    t2, _ = tlsfd(torch.from_numpy(scaled), torch.from_numpy(hat), td, ts,
                  order=order, init_residual=traw.detach())
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-5)
    # the gradient of the raw residual with respect to the state
    jg = np.asarray(jax.grad(lambda u: jloss(u, jnp.asarray(hat))[1].sum())(
        jnp.asarray(uvp)))
    tg, = torch.autograd.grad(traw.sum(), u_t)
    gap = np.linalg.norm(tg.numpy() - jg) / np.linalg.norm(jg)
    assert gap <= 1e-4, gap
    # one sample without the batch axis gives scalars
    one, raw_one = tlsfd(torch.from_numpy(uvp[1]), torch.from_numpy(hat[1]),
                         dataclasses.replace(td, theta=td.theta[1]), ts,
                         order=order)
    assert one.shape == raw_one.shape == ()
    np.testing.assert_allclose(float(raw_one), float(traw[1]), rtol=1e-6)


def test_lsfd_residual_segment_matches_jax():
    """The segment engine's form, on one MeshSample batch (the JAX pool's
    statics on both sides); JAX vmaps its per-sample function."""
    from gen_fvgn_tpu.fv.lsfd import lsfd_residual as jlsfd
    from gen_fvgn_tpu_torch.fv.lsfd import lsfd_residual as tlsfd
    jb, tb, nb = batches(seed=6)
    hat = _hat(nb.uvp)
    run = jax.vmap(lambda u, h, s, i: jlsfd(u, h, s, "2nd", i),
                   in_axes=(0, 0, 0, None))
    j1, jraw = run(jb.uvp, jnp.asarray(hat), jb, None)
    t1, traw = tlsfd(tb.uvp, torch.from_numpy(hat), tb, "2nd")
    np.testing.assert_allclose(traw.numpy(), np.asarray(jraw), rtol=1e-5)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-6)
    run2 = jax.vmap(lambda u, h, s, i: jlsfd(u, h, s, "2nd", i))
    j2, _ = run2(0.5 * jb.uvp, jnp.asarray(hat), jb, jraw)
    t2, _ = tlsfd(0.5 * tb.uvp, torch.from_numpy(hat), tb, "2nd",
                  init_residual=traw)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-5)


def test_lsfd_refusals():
    from gen_fvgn_tpu_torch.fv.lsfd import lsfd_residual, lsfd_residual_block
    _, tb, _ = batches()
    hat = torch.zeros(tb.uvp.shape[:-1] + (2,))
    with pytest.raises(ValueError, match="order"):
        lsfd_residual(tb.uvp, hat, tb, "1st")
    _, _, ts, td = _block_pools("2nd", rows="grad")
    assert ts.ops.wlsq_n_q == 2
    hat = torch.zeros(td.uvp.shape[:-1] + (2,))
    with pytest.raises(ValueError, match="wlsq_block_rows='full'"):
        lsfd_residual_block(td.uvp, hat, td, ts)
    with pytest.raises(ValueError, match="order"):
        lsfd_residual_block(td.uvp, hat, td, ts, order="1st")
