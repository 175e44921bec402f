"""PyTorch port, the composed NodeBlock aggregation on column windows
(`ops/blocksparse.py::apply_node_agg`): nbr_r·e[..., :h/2] +
nbr_s·e[..., h/2:] computed at width h/2 must give the bits of the
full-width composition `(nbr_r·e)[..., :h/2] + (nbr_s·e)[..., h/2:]`
(what the JAX package computes, `models/gn_block.py:110-112`), forward and
backward, in float32 and bf16. On the CPU both run the kernel's plain
version (`spmm_reference`) or `csr_matmul`; the kernel itself is held
against that plain version on the card (tests/test_torch_cuda_kernels.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N_NODES, N_EDGES = 300, 520


def _ops(op_dtype):
    """nbr_r, nbr_s [N ← E] like a mesh's: a few entries a row, integer
    values for a bf16-stored operator, the last 20 node rows empty."""
    from gen_fvgn_tpu_torch.ops.blocksparse import build_linop
    rng = np.random.default_rng(3)
    out = {}
    for name in ("nbr_r", "nbr_s"):
        rows = np.repeat(np.arange(N_NODES - 20), 6)
        centre = rows * N_EDGES // N_NODES
        cols = np.clip(centre + rng.integers(-25, 25, rows.shape[0]), 0,
                       N_EDGES - 1)
        vals = (rng.integers(1, 4, rows.shape[0]) if op_dtype == "bfloat16"
                else rng.normal(size=rows.shape[0])).astype(np.float32)
        out[name] = build_linop(rows, cols, vals, N_NODES, N_EDGES, op_dtype)
    return SimpleNamespace(**out)


def _full_width(ops, e):
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop
    h2 = e.shape[-1] // 2
    return (apply_linop(ops.nbr_r, e)[..., :h2]
            + apply_linop(ops.nbr_s, e)[..., h2:])


@pytest.mark.parametrize("op_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 128), (1, 256), (None, 128),
                                   (2, 64)])
def test_windowed_node_agg_is_bitwise_the_full_width_composition(
        shape, dtype, op_dtype):
    """Widths 128 and 256 (windows of 64 and 128: K1's route), an
    unbatched operand, and width 64 (windows of 32: `csr_matmul`)."""
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_node_agg
    ops = _ops(op_dtype)
    b, h = shape
    size = (N_EDGES, h) if b is None else (b, N_EDGES, h)
    rng = np.random.default_rng(h + (b or 0))
    e0 = torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(
        size=size[:-2] + (N_NODES, h // 2)).astype(np.float32))

    e_ref = e0.clone().requires_grad_(True)
    ref = _full_width(ops, e_ref)
    e_new = e0.clone().requires_grad_(True)
    got = apply_node_agg(ops, e_new)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)
    assert bool((got[..., N_NODES - 20:, :] == 0).all())

    ref.backward(g.to(ref.dtype))
    got.backward(g.to(got.dtype))
    assert e_new.grad.dtype == e_ref.grad.dtype == dtype
    assert torch.equal(e_new.grad, e_ref.grad)


def test_windowed_node_agg_launches_as_the_full_width_applies():
    """The plain versions are taken on CPU tensors: no kernel launch is
    counted, and `plain_versions()` gives the same bits."""
    from gen_fvgn_tpu_torch.ops import plain_versions, spmm
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_node_agg
    ops = _ops("bfloat16")
    e = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, N_EDGES, 128)).astype(np.float32)).to(torch.bfloat16)
    before = spmm.LAUNCHES
    a = apply_node_agg(ops, e)
    with plain_versions():
        b = apply_node_agg(ops, e)
    assert spmm.LAUNCHES == before
    assert torch.equal(a, b)
