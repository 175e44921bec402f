"""PyTorch port, the tools around the FV residual against the JAX package:
the LU form of the WLSQ gradient `ops/wlsq.py::node_based_wlsq` (row
normalization, the order-dependent ridge, padded nodes, `rt_cond`), the
mass-imbalance functional `fv/mass.py` and the analytic oracle
`utils/analytic.py`.

Both sides solve the same moments (the JAX `wlsq_moments` of the cavity's
stencil). A batched LU of a node's system carries about its condition
number times the type's rounding, and at 3rd order the cavity's boundary
nodes reach a condition of 2.7e6 (fewer neighbours than unknowns, kept
finite by the 1e-6 ridge). So each node's derivatives are held within
max(tol, r · cond) of the output's scale and each condition number within
max(cond_tol, r · cond) relative, r = 1e-7 in float32 and 1e-15 in float64
(measured: error over condition at most 1.5e-8 and 3e-17). Measured
largest gaps: float64 1.3e-15 (2nd order) and 2.3e-11 (3rd), condition
numbers 3.2e-15 and 1.4e-10 (tol 1e-10, cond_tol 1e-10); float32 7.7e-7
(2nd) and 1.2e-2 at a node of condition 2.7e6 (3rd; 1.6e-7 at the nodes
below 1e3), condition numbers 1.4e-6 and 9.1e-2 there (tol 1e-4,
cond_tol 1e-3). The analytic field: values, gradients and Hessians within
1e-12 (float64; measured 0) and 1e-6 (float32; 5.8e-8) of JAX's; the mass
functional within 1e-12 relative (both NumPy; measured 0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import CASE_KW, _with_outflow


def _mesh(n=8):
    """The outflow cavity of n x n cells, compiled, with its 2-hop WLSQ
    stencil (the JAX package's)."""
    from gen_fvgn_tpu.meshes.geometry import build_stencil, compile_mesh
    from gen_fvgn_tpu.meshes.synthetic import cavity_quad_mesh
    m = _with_outflow(cavity_quad_mesh(n))
    mesh = compile_mesh({k: m[k] for k in ("node|pos", "node|node_type",
                                           "cells_node", "cells_index")})
    mesh["stencil"] = build_stencil(
        mesh["face|face_node"].astype(np.int64),
        mesh["face_node_x"].astype(np.int64), mesh["node|pos"].shape[0],
        k_hop=2)
    return mesh


def _inputs(order, dtype, n_pad_extra=5, seed=0):
    """(phi, stencil, A, single_B, colscale, node_mask) as NumPy arrays of
    `dtype`: the JAX moments of the cavity's stencil, with a few padded
    nodes (identity systems) after the real ones."""
    from gen_fvgn_tpu.ops.wlsq import wlsq_moments
    mesh = _mesh()
    pos = mesh["node|pos"].astype(np.float64)
    st = mesh["stencil"].astype(np.int32)
    with jax.enable_x64(dtype == np.float64):
        A, wB, cs = wlsq_moments(jnp.asarray(pos.astype(dtype)),
                                 jnp.asarray(st), order)
        A, wB, cs = (np.asarray(a, dtype) for a in (A, wB, cs))
    n = pos.shape[0]
    k = A.shape[-1]
    pad = lambda a, fill=0.0: np.concatenate(
        [a, np.full((n_pad_extra,) + a.shape[1:], fill, a.dtype)])
    A = pad(A)
    cs = pad(cs, 1.0)
    mask = np.arange(n + n_pad_extra) < n
    rng = np.random.default_rng(seed)
    phi = (rng.normal(size=(n + n_pad_extra, 3)) * mask[:, None]).astype(
        dtype)
    assert A.shape == (n + n_pad_extra, k, k)
    return phi, st, A, wB, cs, mask


ROUNDING = {np.float32: 1e-7, np.float64: 1e-15}


@pytest.mark.parametrize("order,dtype,tol,cond_tol", [
    ("2nd", np.float64, 1e-10, 1e-10),
    ("3rd", np.float64, 1e-10, 1e-10),
    ("2nd", np.float32, 1e-4, 1e-3),
    ("3rd", np.float32, 1e-4, 1e-3)],
    ids=["2nd-float64", "3rd-float64", "2nd-float32", "3rd-float32"])
def test_node_based_wlsq_matches_jax(order, dtype, tol, cond_tol):
    from gen_fvgn_tpu.ops.wlsq import node_based_wlsq as jwlsq
    from gen_fvgn_tpu_torch.ops.wlsq import node_based_wlsq as twlsq
    phi, st, A, wB, cs, mask = _inputs(order, dtype)
    with jax.enable_x64(dtype == np.float64):
        jn, jc = jwlsq(jnp.asarray(phi), jnp.asarray(st), jnp.asarray(A),
                       jnp.asarray(wB), order, colscale=jnp.asarray(cs),
                       node_mask=jnp.asarray(mask), rt_cond=True)
        jn, jc = np.asarray(jn), np.asarray(jc)
    t = torch.from_numpy
    tn, tc = twlsq(t(phi), t(st.astype(np.int64)), t(A), t(wB), order,
                   colscale=t(cs), node_mask=t(mask), rt_cond=True)
    tn, tc = tn.numpy(), tc.numpy()
    assert tn.shape == jn.shape == (phi.shape[0], 3, A.shape[-1])
    assert tn.dtype == dtype and tc.shape == jc.shape
    r_cond = ROUNDING[dtype] * jc
    per_node = np.abs(tn - jn).max(axis=(1, 2)) / np.abs(jn).max()
    assert (per_node <= np.maximum(tol, r_cond)).all(), per_node.max()
    assert (np.abs(tc / jc - 1.0) <= np.maximum(cond_tol, r_cond)).all()
    assert not tn[~mask].any()
    # batch-major: two samples at once give each sample's result
    batched = twlsq(t(np.stack([phi, 2 * phi])), t(np.stack([st, st])
                    .astype(np.int64)), t(np.stack([A, A])),
                    t(np.stack([wB, wB])), order,
                    colscale=t(np.stack([cs, cs])),
                    node_mask=t(np.stack([mask, mask])))
    np.testing.assert_allclose(batched[0].numpy(), tn, rtol=0,
                               atol=1e-6 * np.abs(tn).max())
    np.testing.assert_allclose(batched[1].numpy(), 2 * tn, rtol=0,
                               atol=2e-6 * np.abs(tn).max())


def test_node_based_wlsq_converges_on_the_analytic_field():
    """On the analytic field in float64, the LU form's gradient at the
    interior nodes converges to the field's own gradient at second order:
    halving the cell size divides the largest error by at least 1/0.3
    (measured 0.268: 0.267 on the 8 x 8-cell cavity, 0.071 on 16 x 16)."""
    from gen_fvgn_tpu_torch.ops.wlsq import node_based_wlsq, wlsq_moments
    from gen_fvgn_tpu_torch.utils.analytic import eval_field
    gaps = []
    for n in (8, 16):
        mesh = _mesh(n)
        pos = mesh["node|pos"].astype(np.float64)
        st = mesh["stencil"].astype(np.int64)
        A, wB, cs = wlsq_moments(pos.astype(np.float32), st, "2nd")
        phi, grad, _ = eval_field(pos)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
        nabla = node_based_wlsq(t(phi), torch.from_numpy(st), t(A), t(wB),
                                "2nd", colscale=t(cs)).numpy()
        interior = np.asarray(mesh["node|node_type"]).reshape(-1) == 0
        gaps.append(np.abs(nabla[interior, 0, 0:2] - grad[interior]).max())
    assert gaps[1] <= 0.3 * gaps[0], gaps


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_analytic_field_matches_jax(dtype, tol):
    from gen_fvgn_tpu.utils.analytic import eval_field as jeval
    from gen_fvgn_tpu_torch.utils.analytic import eval_field as teval
    pos = np.random.default_rng(2).uniform(size=(50, 2)).astype(dtype)
    kw = dict(phi_x=0.7, alpha_y=2.0)
    with jax.enable_x64(dtype == np.float64):
        ref = jeval(pos, **kw)
    got = teval(pos, **kw)
    for r, g, shape in zip(ref, got, ((50, 1), (50, 2), (50, 2, 2))):
        assert g.shape == r.shape == shape and g.dtype == dtype
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=tol * max(np.abs(r).max(), 1.0))


def test_mass_imbalance_matches_jax():
    from gen_fvgn_tpu.fv import mass as jmass
    from gen_fvgn_tpu_torch.fv import mass as tmass
    mesh = _mesh()
    rng = np.random.default_rng(4)
    n = mesh["node|pos"].shape[0]
    u, v = rng.normal(size=n), rng.normal(size=n)
    np.testing.assert_array_equal(tmass.face_area_vectors(mesh),
                                  jmass.face_area_vectors(mesh))
    got = tmass.node_mass_imbalance_l1(mesh, u, v)
    ref = jmass.node_mass_imbalance_l1(mesh, u, v)
    assert got[1] > 0
    np.testing.assert_allclose(got, ref, rtol=1e-12)
