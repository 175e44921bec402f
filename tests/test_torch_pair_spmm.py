"""PyTorch port, the paired sparse applies K8 (pair sum) and K9 (pair
transpose) on the CPU, against the JAX package.

* The plain versions `pair_sum_reference` / `pair_transpose_reference`
  against the JAX Pallas kernels `pallas_gather_pair` /
  `pallas_pair_transpose` in interpret mode (as tests/test_pallas_spmm.py
  runs them), on the same operators built once as the JAX package's dense
  tiles and once as the port's CSR from the same COO triplets, at H = 64
  and H = 128. float32: K8 within 1e-5 (tests/test_pallas_spmm.py holds
  the kernel to that against its take reference), K9 within 1e-4 (as
  there). bfloat16: one bf16 rounding of the output, plus float32
  round-off of 2⁻²⁰ of the sum of the magnitudes (the two sides add their
  float32 products in another order, and a sum may cancel).
* `apply_gather_pair` and `apply_node_pair` against the JAX functions on a
  real mesh's operators, with the JAX switches on: values and input
  cotangents within 2 bf16 ulps of each output's scale; the node pair's
  bf16 output in the float32 configuration (a reference quirk); the gather
  pair's `pre` bit-identical to the take route's on real edge rows, zero on
  the padded ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import both_sides, jax_kernels_on
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

torch.set_num_threads(1)

BF16_EPS = 2.0 ** -8


def _ulps(ref, n):
    scale = float(np.abs(ref).max())
    return n * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _pair_ops(seed, n_out, n_in, integer_vals, dtype):
    """Two [n_out ← n_in] operators with RCM-like locality (row e reads
    columns near e·n_in/n_out), as JAX BlockOps (256 tiles) and as the
    port's CSR from the same COO; and the JAX union-window metadata."""
    from gen_fvgn_tpu.ops.blocksparse import build_block_op
    from gen_fvgn_tpu.ops.pallas_spmm import build_pair_window_meta
    from gen_fvgn_tpu_torch.ops.blocksparse import build_csr_op
    rng = np.random.default_rng(seed)
    base = np.arange(n_out) * n_in // n_out
    jops, tops = [], []
    for _ in range(2):
        rows = np.repeat(np.arange(n_out - 40), 2)   # the last 40 rows empty
        cols = np.clip(base[rows] + rng.integers(-40, 40, rows.shape[0]), 0,
                       n_in - 1)
        vals = (rng.integers(1, 4, rows.shape[0]) if integer_vals
                else rng.normal(size=rows.shape[0])).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
        jops.append(build_block_op(rows, cols, vals, n_out, n_in, 256, 256,
                                   dtype=jdt))
        tops.append(build_csr_op(rows, cols, vals, n_out, n_in, dtype))
    meta = build_pair_window_meta(jops[0].blocks, jops[0].in_tile,
                                  jops[1].blocks, jops[1].in_tile,
                                  s_tiles=2)
    assert meta is not None
    return jops, tops, meta


def _abs_sum(fn, a, b, x):
    """The same apply on |values| and |x| in float32: the scale of the
    float32 round-off."""
    import dataclasses
    def absolute(op):
        return dataclasses.replace(op, val=op.val.abs(), dtype=torch.float32,
                                   _csr=None)
    return fn(absolute(a), absolute(b), x.abs().float()).numpy()


def _check(got, ref, dtype, abs_sum, f32_tol):
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=f32_tol, atol=f32_tol)
    else:
        tol = BF16_EPS * np.abs(ref) + 2.0 ** -20 * abs_sum
        assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 128, 256])
def test_pair_sum_reference_matches_pallas_gather_pair(h, dtype):
    from gen_fvgn_tpu.ops.pallas_spmm import pallas_gather_pair
    from gen_fvgn_tpu_torch.ops.pair_spmm import pair_sum, pair_sum_reference
    n_out, n_in, b = 1536, 1024, 2
    jops, tops, (ws, la, lb, w, s, pad) = _pair_ops(
        h, n_out, n_in, dtype == "bfloat16", dtype)
    y = np.random.default_rng(h + 1).normal(size=(b, n_in, 2 * h)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    yj = jnp.asarray(y, jdt)
    ref = np.asarray(pallas_gather_pair(
        jops[0].blocks, jops[1].blocks, jnp.asarray(ws), jnp.asarray(la),
        jnp.asarray(lb), yj, w_tiles=w, s_tiles=s, n_to_pad=pad,
        interpret=True, out_dtype=jdt), np.float32)
    yt = torch.from_numpy(np.array(yj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = pair_sum_reference(tops[0], tops[1], yt)
    _check(got, ref, dtype, _abs_sum(pair_sum_reference, *tops, yt), 1e-5)
    assert bool((got[:, n_out - 40:] == 0).all())
    # the wrapper takes the plain version on a CPU tensor and counts nothing
    from gen_fvgn_tpu_torch.ops import pair_spmm as mod
    before = mod.LAUNCHES_PAIR_SUM
    assert torch.equal(pair_sum(tops[0], tops[1], yt), got)
    assert mod.LAUNCHES_PAIR_SUM == before
    # unbatched [n_in, 2H] is lane 0 of the batched form
    assert torch.equal(pair_sum_reference(tops[0], tops[1], yt[0]), got[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 128, 48, 256])
def test_pair_transpose_reference_matches_pallas_pair_transpose(h, dtype):
    from gen_fvgn_tpu.ops.pallas_spmm import pallas_pair_transpose
    from gen_fvgn_tpu_torch.ops.pair_spmm import (pair_transpose,
                                                  pair_transpose_reference)
    n_out, n_in, b = 1536, 1024, 2
    jops, tops, (ws, la, lb, w, s, pad) = _pair_ops(
        h + 7, n_out, n_in, dtype == "bfloat16", dtype)
    g = np.random.default_rng(h + 2).normal(size=(b, n_in, h)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    gj = jnp.asarray(g, jdt)
    ref = np.asarray(pallas_pair_transpose(
        jops[0].blocks, jops[1].blocks, jnp.asarray(ws), jnp.asarray(la),
        jnp.asarray(lb), gj, w_tiles=w, s_tiles=s, n_to_pad=pad,
        interpret=True, out_dtype=jdt), np.float32)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = pair_transpose_reference(tops[0], tops[1], gt)
    assert tuple(got.shape) == (b, n_out, 2 * h)
    _check(got, ref, dtype, _abs_sum(pair_transpose_reference, *tops, gt),
           1e-4)
    from gen_fvgn_tpu_torch.ops import pair_spmm as mod
    before = mod.LAUNCHES_PAIR_TRANSPOSE
    assert torch.equal(pair_transpose(tops[0], tops[1], gt), got)
    assert mod.LAUNCHES_PAIR_TRANSPOSE == before


def test_pair_sum_rounds_once():
    """The plain pair sum adds the two float32 products before its single
    rounding. A·y_lo = 1 + 2⁻⁸ and B·y_hi = 2⁻⁸: rounded once, the sum is
    the exact 1 + 2⁻⁷; rounded three times (each product to bf16, then
    their bf16 sum) it would be 1, since 1 + 2⁻⁸ ties to even."""
    from gen_fvgn_tpu_torch.ops.blocksparse import build_csr_op, csr_matmul
    from gen_fvgn_tpu_torch.ops.pair_spmm import pair_sum_reference
    a = build_csr_op([0, 0], [0, 1], [1.0, 1.0], 1, 2, "bfloat16")
    b = build_csr_op([0], [0], [1.0], 1, 2, "bfloat16")
    y = torch.tensor([[1.0, 2.0 ** -8], [2.0 ** -8, 0.0]],
                     dtype=torch.bfloat16)
    once = pair_sum_reference(a, b, y)
    assert once.dtype == torch.bfloat16
    assert float(once) == 1.0 + 2.0 ** -7
    thrice = csr_matmul(a, y[:, :1]) + csr_matmul(b, y[:, 1:])
    assert float(thrice) == 1.0
    assert pair_sum_reference(a, b, y.float()).dtype == torch.float32


# --------------------------------------------- the applies on mesh operators

BF16 = (6, 128, 1, "bfloat16", 2)


def _mesh_ops():
    (_, _, js, _), (_, _, ts, _) = both_sides(*BF16)
    assert js.ops.gpair_start is not None and js.ops.npair_start is not None
    return js.ops, ts.ops


def _jax_value_and_vjp(fn, y, g):
    out, vjp = jax.vjp(fn, y)
    return np.asarray(out, np.float32), np.asarray(vjp(g)[0], np.float32), \
        out.dtype


def _port_value_and_vjp(fn, y, g):
    y = y.clone().requires_grad_(True)
    out = fn(y)
    out.backward(g)
    return out.detach(), y.grad


def test_apply_gather_pair_matches_jax():
    from gen_fvgn_tpu.ops import blocksparse as jbs
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_gather_pair
    jops, tops = _mesh_ops()
    n, e = tops.adj.fwd.n_out, tops.gather_s.fwd.n_out
    rng = np.random.default_rng(11)
    y = rng.normal(size=(2, n, 256)).astype(np.float32)
    g = rng.normal(size=(2, e, 128)).astype(np.float32)
    yj, gj = jnp.asarray(y, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    with jax_kernels_on(pairs=True):
        ref, dref, rdt = _jax_value_and_vjp(
            jax.vmap(lambda a: jbs.apply_gather_pair(jops, a)), yj, gj)
    assert rdt == jnp.bfloat16
    yt = torch.from_numpy(np.array(yj.astype(jnp.float32))).to(
        torch.bfloat16)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
        torch.bfloat16)
    out, dy = _port_value_and_vjp(lambda a: apply_gather_pair(tops, a), yt,
                                  gt)
    assert out.dtype == dy.dtype == torch.bfloat16
    # two exact bf16 rows added in float32 and rounded once: the same bits
    np.testing.assert_array_equal(out.float().numpy(), ref)
    np.testing.assert_allclose(dy.float().numpy(), dref, rtol=0,
                               atol=_ulps(dref, 2))


def test_gather_pair_pre_is_the_take_routes_on_real_edge_rows():
    """Real edge rows: y[s_e, :H] + y[r_e, H:] in bf16, bit for bit the two
    take-route gathers and their bf16 add. Padded edge rows: zero, where
    the take route holds row 0's data."""
    from gen_fvgn_tpu_torch.ops.blocksparse import (apply_gather_pair,
                                                    apply_linop)
    (_, _, js, _), (_, tp, ts, _) = both_sides(*BF16)
    tops = ts.ops
    n_edges = tp.cases[0]["mesh"]["face|face_node"].shape[1]
    y = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, tops.adj.fwd.n_out, 256)).astype(np.float32)).to(
            torch.bfloat16)
    pair = apply_gather_pair(tops, y)
    take = apply_linop(tops.gather_s, y[..., :128].contiguous()) \
        + apply_linop(tops.gather_r, y[..., 128:].contiguous())
    assert pair.shape == take.shape and n_edges < pair.shape[1]
    assert torch.equal(pair[:, :n_edges], take[:, :n_edges])
    assert bool((pair[:, n_edges:] == 0).all())
    assert bool((take[:, n_edges:] == take[:, n_edges:n_edges + 1]).all())
    assert bool((take[:, n_edges:] != 0).any())


@pytest.mark.parametrize("y_dtype", ["bfloat16", "float32"])
def test_apply_node_pair_matches_jax(y_dtype):
    """bf16 stream, and the float32 configuration with bf16-stored
    operators, where the aggregation comes out bf16 on both sides (the
    operand's cast to bf16 sets the output type) and the input cotangent
    goes back float32."""
    from gen_fvgn_tpu.ops import blocksparse as jbs
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_node_pair
    jops, tops = _mesh_ops()
    assert tops.nbr_r.fwd.dtype == torch.bfloat16
    n, e = tops.nbr_r.fwd.n_out, tops.nbr_r.fwd.n_in
    rng = np.random.default_rng(13)
    y = rng.normal(size=(2, e, 128)).astype(np.float32)
    g = rng.normal(size=(2, n, 64)).astype(np.float32)
    jdt = jnp.bfloat16 if y_dtype == "bfloat16" else jnp.float32
    yj, gj = jnp.asarray(y, jdt), jnp.asarray(g, jnp.bfloat16)
    with jax_kernels_on(pairs=True):
        ref, dref, rdt = _jax_value_and_vjp(
            lambda a: jbs.apply_node_pair(jops, a), yj, gj)
    assert rdt == jnp.bfloat16
    tdt = torch.bfloat16 if y_dtype == "bfloat16" else torch.float32
    yt = torch.from_numpy(np.array(yj.astype(jnp.float32))).to(tdt)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
        torch.bfloat16)
    out, dy = _port_value_and_vjp(lambda a: apply_node_pair(tops, a), yt, gt)
    assert out.dtype == torch.bfloat16 and dy.dtype == tdt
    assert tuple(out.shape) == (2, n, 64) and tuple(dy.shape) == (2, e, 128)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=_ulps(ref, 2))
    np.testing.assert_allclose(dy.float().numpy(), dref, rtol=0,
                               atol=_ulps(dref, 2))
    # the plain two-apply form agrees within the roundings it adds
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop
    with torch.no_grad():
        two = (apply_linop(tops.nbr_r, yt)[..., :64]
               + apply_linop(tops.nbr_s, yt)[..., 64:])
    np.testing.assert_allclose(two.float().numpy(), ref, rtol=0,
                               atol=_ulps(ref, 4))
