"""PyTorch port, kernel K1's module: `spmm_reference` and `apply_linop`
against the JAX package — the windowed Pallas kernel in interpret mode (as
tests/test_pallas_spmm.py runs it) and the JAX `apply_linop` — on operators
built from the same NumPy COO triplets."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

N_OUT, N_IN, TILE = 768, 512, 256


def _banded_coo(seed, integer):
    """A banded operator like an RCM-ordered mesh gives: each row a few
    entries near its own position; the last 40 rows empty (padding)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N_OUT - 40), 5)
    centre = rows * N_IN // N_OUT
    cols = np.clip(centre + rng.integers(-30, 30, rows.shape[0]), 0, N_IN - 1)
    vals = (rng.integers(1, 4, rows.shape[0]).astype(np.float32) if integer
            else rng.normal(size=rows.shape[0]).astype(np.float32))
    return rows, cols, vals


def _both_ops(seed, dtype):
    from gen_fvgn_tpu.ops.blocksparse import build_linop as jbuild
    from gen_fvgn_tpu_torch.ops.blocksparse import build_linop as tbuild
    rows, cols, vals = _banded_coo(seed, integer=(dtype == "bfloat16"))
    jop = jbuild(rows, cols, vals, N_OUT, N_IN, TILE, TILE,
                 dtype if dtype == "bfloat16" else np.float32, window_s=2)
    top = tbuild(rows, cols, vals, N_OUT, N_IN, dtype)
    return jop, top


def _window(jblk, x, out_dtype):
    from gen_fvgn_tpu.ops.pallas_spmm import pallas_block_spmm_window
    assert jblk.win_start is not None
    return np.asarray(pallas_block_spmm_window(
        jblk.blocks, jblk.win_start, jblk.win_local, x, w_tiles=jblk.win_w,
        s_tiles=jblk.win_s, n_to_pad=jblk.win_pad, out_dtype=out_dtype,
        interpret=True), np.float32)


@pytest.mark.parametrize("batched", [True, False])
def test_spmm_reference_bf16_matches_pallas_window(batched):
    """bf16 operand, bf16 (integer) operator, bf16 out. Both accumulate
    exact products in float32 in a different order; the sums can differ in
    the last float32 bit, i.e. by at most one bf16 rounding (2^-8) of the
    output."""
    from gen_fvgn_tpu_torch.ops.spmm import spmm_reference
    jop, top = _both_ops(0, "bfloat16")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, N_IN, 128)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ref = _window(jop.fwd, xj, jnp.bfloat16)
    if batched:
        got = spmm_reference(top.fwd, xt)
    else:
        got = torch.stack([spmm_reference(top.fwd, xt[b]) for b in range(3)])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)
    assert (got.float().numpy()[:, N_OUT - 40:] == 0).all()


def test_spmm_reference_f32_operator_matches_pallas_window():
    """float32 operand and operator (real values): rtol 1e-5."""
    from gen_fvgn_tpu_torch.ops.spmm import spmm_reference
    jop, top = _both_ops(2, "float32")
    x = np.random.default_rng(3).normal(size=(2, N_IN, 128)).astype(np.float32)
    ref = _window(jop.fwd, jnp.asarray(x), jnp.float32)
    got = spmm_reference(top.fwd, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_transpose_direction_matches_jax(direction):
    from gen_fvgn_tpu.ops.blocksparse import _apply_block_op
    from gen_fvgn_tpu_torch.ops.blocksparse import _apply_csr_op
    jop, top = _both_ops(4, "float32")
    n = N_IN if direction == "fwd" else N_OUT
    x = np.random.default_rng(5).normal(size=(n, 16)).astype(np.float32)
    ref = np.asarray(_apply_block_op(getattr(jop, direction), jnp.asarray(x)))
    got = _apply_csr_op(getattr(top, direction), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [12, 32, 128])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_apply_linop_casts_and_out_dtype_match_jax(width, xdtype):
    """A bf16-stored operator rounds a float32 operand to bf16 and still
    emits float32; bf16 in gives bf16 out. Products are exact, so the only
    gap is the float32 summation order."""
    from gen_fvgn_tpu.ops.blocksparse import apply_linop as japply
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop as tapply
    jop, top = _both_ops(6, "bfloat16")
    x = np.random.default_rng(7).normal(size=(2, N_IN, width)).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if xdtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x).to(getattr(torch, xdtype))
    ref = japply(jop, xj)
    got = tapply(top, xt)
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    tol = 2 ** -8 if xdtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=1e-6)


@pytest.mark.parametrize("xdtype,width,takes", [
    ("bfloat16", 128, True),     # 256 bytes a row: row gather
    ("float32", 64, True),       # 256 bytes a row: row gather, exact in f32
    ("float32", 32, False),      # 128 bytes: sparse product, bf16 operand
    ("bfloat16", 64, False)])
def test_take_route_matches_jax(xdtype, width, takes):
    """Row-gather operators: at >= 256 bytes a row the forward is a gather in
    the operand's own type and padded rows carry row 0's data (not zero);
    below, the sparse product zeroes padded rows."""
    from gen_fvgn_tpu.ops.blocksparse import apply_linop as japply
    from gen_fvgn_tpu.ops.blocksparse import build_linop as jbuild
    from gen_fvgn_tpu.ops.blocksparse import gather_coo as jcoo
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop as tapply
    from gen_fvgn_tpu_torch.ops.blocksparse import build_linop as tbuild
    from gen_fvgn_tpu_torch.ops.blocksparse import gather_coo as tcoo
    rng = np.random.default_rng(8)
    e_real = N_OUT - 40
    idx = rng.integers(0, N_IN, e_real)
    take = np.zeros(N_OUT, np.int64)
    take[:e_real] = idx
    jop = jbuild(*jcoo(idx), N_OUT, N_IN, TILE, TILE, dtype="bfloat16",
                 fwd_take=take.astype(np.int32))
    top = tbuild(*tcoo(idx), N_OUT, N_IN, dtype="bfloat16", fwd_take=take)
    x = rng.normal(size=(2, N_IN, width)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, xdtype))
    xt = torch.from_numpy(x).to(getattr(torch, xdtype))
    ref = np.asarray(japply(jop, xj), np.float32)
    got = tapply(top, xt).float().numpy()
    np.testing.assert_array_equal(got, ref)
    pad_is_row0 = np.array_equal(got[:, e_real:],
                                 np.broadcast_to(xt.float().numpy()[:, :1],
                                                 got[:, e_real:].shape))
    assert pad_is_row0 == takes
    if not takes:
        assert (got[:, e_real:] == 0).all()


def test_spmm_wrapper_on_cpu_is_the_reference_and_counts_nothing():
    from gen_fvgn_tpu_torch.ops import spmm as mod
    _, top = _both_ops(0, "bfloat16")
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(N_IN, 128)).astype(np.float32)).to(torch.bfloat16)
    before = mod.LAUNCHES
    out = mod.spmm(top.fwd, x)
    assert mod.LAUNCHES == before
    assert torch.equal(out, mod.spmm_reference(top.fwd, x))


def test_duplicate_triplets_accumulate():
    from gen_fvgn_tpu_torch.ops.blocksparse import build_linop
    op = build_linop([0, 0, 1], [2, 2, 0], [1.0, 2.0, 5.0], 4, 3)
    dense = op.fwd.to_dense().numpy()
    assert dense[0, 2] == 3.0 and dense[1, 0] == 5.0 and dense.sum() == 8.0
    np.testing.assert_array_equal(op.bwd.to_dense().numpy(), dense.T)
