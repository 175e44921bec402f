"""PyTorch port, the FV residual and the pieces around the backbone:
`integrate_residuals_block_packed`, the normalizer, the Dirichlet overwrite
and one `forward_batch_block` against the JAX package on the same NumPy
inputs, float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, f32_operator_statics,
                               jax_norm_state, numpy_norm_stats,
                               numpy_params, random_state, torch_norm_state,
                               torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)


def _fields(seed, n_pad, mask, batch=2):
    rng = np.random.default_rng(seed)
    uvp = rng.normal(size=(batch, n_pad, 3)).astype(np.float32)
    uvp *= mask[None, :, None]
    return uvp, (uvp[..., 0:2] * 0.7).copy(), (uvp[..., 0:2] * 0.4).copy()


@pytest.mark.parametrize("conserved,ncn", [(True, True), (False, True),
                                           (True, False)])
def test_integrator_packed_matches_jax(conserved, ncn):
    """All four losses, rt_uvp and uvp_cell, rtol 1e-4 (float32 sparse sums
    in a different order)."""
    from gen_fvgn_tpu.fv.integrator_block_packed import \
        integrate_residuals_block_packed as jint
    from gen_fvgn_tpu_torch.fv.integrator_block_packed import \
        integrate_residuals_block_packed as tint
    (_, _, js, jd), (_, _, ts, td) = both_sides()
    mask = np.asarray(js.node_mask, np.float32)
    uvp, uv_hat, uv_old = _fields(20, ts.pos.shape[0], mask)
    jl, jrt, jcell = jint(jnp.asarray(uvp), jnp.asarray(uv_hat),
                          jnp.asarray(uv_old), jd, js,
                          conserved_form=conserved, ncn_smooth=ncn)
    tl, trt, tcell = tint(torch.from_numpy(uvp), torch.from_numpy(uv_hat),
                          torch.from_numpy(uv_old), td, ts,
                          conserved_form=conserved, ncn_smooth=ncn)
    for name in ("cont", "mom_x", "mom_y", "press"):
        ref = np.asarray(getattr(jl, name))
        got = getattr(tl, name).numpy()
        assert got.shape == ref.shape == (2,)
        assert (ref > 0).all(), f"{name} residual is exercised"
        np.testing.assert_allclose(got, ref, rtol=1e-4)
    for ref, got in ((jrt, trt), (jcell, tcell)):
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_integrator_padded_rows_stay_zero():
    from gen_fvgn_tpu_torch.fv.integrator_block_packed import \
        integrate_residuals_block_packed as tint
    _, (_, tpool, ts, td) = both_sides()
    mask = ts.node_mask.numpy().astype(np.float32)
    uvp, uv_hat, uv_old = _fields(21, ts.pos.shape[0], mask)
    _, rt, cell = tint(torch.from_numpy(uvp), torch.from_numpy(uv_hat),
                       torch.from_numpy(uv_old), td, ts)
    n = tpool.cases[0]["mesh"]["node|pos"].shape[0]
    c = tpool.cases[0]["mesh"]["cell|centroid"].shape[0]
    assert (rt[:, n:] == 0).all() and (cell[:, c:] == 0).all()
    assert torch.isfinite(rt).all() and torch.isfinite(cell).all()


def test_pack_unpack_round_trip():
    from gen_fvgn_tpu_torch.fv.integrator_block_packed import (pack_cm,
                                                               unpack_cm)
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    cm = pack_cm(x)
    assert tuple(cm.shape) == (5, 6)
    assert cm[4, 2 * 2 + 1] == x[1, 4, 2]      # column c*B + b
    assert torch.equal(unpack_cm(cm, 2), x)


@pytest.mark.parametrize("accumulate", [False, True])
def test_normalizer_matches_jax(accumulate):
    from gen_fvgn_tpu.training.normalizer import normalize as jnorm
    from gen_fvgn_tpu_torch.training.normalizer import normalize as tnorm
    stats = numpy_norm_stats()
    rng = np.random.default_rng(22)
    rows = rng.normal(size=(2, 40, 9)).astype(np.float32)
    mask = rng.uniform(size=(2, 40)) > 0.3
    jout, jstate = jnorm(jax_norm_state(stats), jnp.asarray(rows),
                         jnp.asarray(mask), 100.0, accumulate=accumulate)
    tout, tstate = tnorm(torch_norm_state(stats), torch.from_numpy(rows),
                         torch.from_numpy(mask), 100.0, accumulate=accumulate)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_acc"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                   np.asarray(getattr(jstate, f)), rtol=1e-6)


def test_fresh_normalizer_is_identity_without_accumulation():
    from gen_fvgn_tpu_torch.training.normalizer import (init_normalizer,
                                                        normalize)
    rows = torch.randn(3, 7, 9, generator=torch.Generator().manual_seed(0))
    out, state = normalize(init_normalizer(9, device="cpu"), rows,
                           torch.ones(3, 7, dtype=torch.bool), 10.0,
                           accumulate=False)
    assert torch.equal(out, rows) and float(state.num_acc) == 1.0


def test_enforce_boundary_conditions_matches_jax():
    from gen_fvgn_tpu.training.forward import \
        enforce_boundary_conditions as jbc
    from gen_fvgn_tpu_torch.training.forward import \
        enforce_boundary_conditions as tbc
    (_, _, js, jd), (_, _, ts, td) = both_sides()
    rng = np.random.default_rng(23)
    uvp = rng.normal(size=tuple(td.uvp.shape)).astype(np.float32)
    node_type = np.asarray(js.node_type).copy()
    node_type[5] = 4                                   # a PRESS_POINT
    ref = np.asarray(jbc(jnp.asarray(uvp), jnp.asarray(node_type),
                         jd.target_uv))
    got = tbc(torch.from_numpy(uvp), torch.from_numpy(node_type),
              td.target_uv).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 5, 2] == 0).all()
    # a bf16 backbone output is promoted to float32 by the overwrite
    out16 = tbc(torch.from_numpy(uvp).to(torch.bfloat16),
                torch.from_numpy(node_type), td.target_uv)
    assert out16.dtype == torch.float32


@pytest.mark.parametrize("integrator", ["imex", "explicit", "implicit"])
def test_forward_batch_block_matches_jax(integrator):
    """One forward on float32-stored operators, float32 model: losses rtol
    1e-4, states atol 1e-5 (measured gap below 1e-6)."""
    from gen_fvgn_tpu.training.forward_block import \
        forward_batch_block as jfwd
    from gen_fvgn_tpu_torch.training.forward_block import \
        forward_batch_block as tfwd
    (jc, _, _, jd), (tc, _, _, td) = both_sides()
    js, ts = f32_operator_statics()
    jc = jc.replace(integrator=integrator)
    tc = tc.replace(integrator=integrator)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd2, td2 = random_state(jd, td, np.asarray(js.node_mask), seed=24)
    jout = jfwd(apply_fn, jax.tree_util.tree_map(jnp.asarray, tree),
                jax_norm_state(stats), jd2, js, jc,
                accumulate_normalizer=False)
    with torch.no_grad():
        tout = tfwd(torch_simulator(tc, tree), torch_norm_state(stats), td2,
                    ts, tc, accumulate_normalizer=False)
    for f in ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=1e-4)
    real = np.asarray(js.node_mask)
    np.testing.assert_allclose(tout.uvp_node_new.numpy()[:, real],
                               np.asarray(jout.uvp_node_new)[:, real],
                               atol=1e-5)
    np.testing.assert_allclose(tout.uvp_cell_new.numpy(),
                               np.asarray(jout.uvp_cell_new), atol=1e-5)
