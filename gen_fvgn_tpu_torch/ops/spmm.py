"""Kernel K1: batched sparse apply out[b] = A · x[b] on the card.

Replaces the TPU kernels of `gen_fvgn_tpu/ops/pallas_spmm.py`:
`pallas_block_spmm_window` (:172, the one the main path runs),
`pallas_block_spmm_binner` (:260), `pallas_block_spmm` (:311) and
`pallas_block_spmm_batched` (:70) — one function, four grids. They stream
256×256 dense tiles of the operator through the matrix unit. The CUDA kernel
(csrc/spmm.cu) computes the same function from the CSR form: a warp per
output row for all batch lanes, the row's indices loaded once and
broadcast by shuffles, each lane owning 16-byte vectors of the B × F
outputs with eight operand loads in flight, float32 accumulators.

What bounds it here: bytes. The operators carry a few to a few tens of
non-zeros a row, so the work is a gather-accumulate — the operand is read
once if the gathered rows stay in L2 (the mesh is RCM-ordered, so a row's
neighbours are close by), the output written once, and the float32 FMA
count (2·nnz·B·F) is far below the card's rate.

The kernel takes column windows at any F % 64 == 0: the operand and the
output may be views of wider tensors (unit stride along F, 16-byte aligned
rows), so the composed node aggregation (ops/blocksparse.py::
apply_node_agg) reads and writes its two halves in place.

Tolerance against `spmm_reference`: both accumulate in float32, in a
different order. With the integer weights of the structural operators the
float32 sums can differ in the last bit, which after the cast to bfloat16
is at most one bf16 rounding of the output (2⁻⁸ relative).
"""

from __future__ import annotations

from typing import Optional

import torch

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0


def spmm_reference(op, x: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same rounding points: the
    operand is cast to bfloat16 when the operator is stored bfloat16, the
    product accumulates in float32, and the output type follows the
    operand/operator rule. x: [n_in, F] or [B, n_in, F]; `out`, when
    given, receives the result (a window of a wider tensor). Used for CPU
    tensors, and as the yardstick of the kernel on the card."""
    from gen_fvgn_tpu_torch.ops.blocksparse import csr_matmul
    res = csr_matmul(op, x)
    if out is None:
        return res
    out.copy_(res)
    return out


def _window_ok(t: torch.Tensor) -> bool:
    """A view the kernel can address: unit stride along F, rows and batch
    lanes 16-byte aligned."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * es) % 16 == 0 for s in t.stride()[:-1]))


def spmm(op, x: torch.Tensor,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = A @ x for x [n_in, F] or [B, n_in, F] with F a multiple of 64.
    x may be a column window of a wider tensor, and `out` a window to write
    into (its type must be the one `_out_dtype` gives).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    `spmm_reference`."""
    if x.device.type != "cuda":
        return spmm_reference(op, x, out)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    from gen_fvgn_tpu_torch.ops.blocksparse import _out_dtype
    global LAUNCHES
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"spmm kernel takes bfloat16 or float32, got {x.dtype}")
    if x.ndim not in (2, 3):
        raise ValueError(f"spmm kernel takes [n_in, F] or [B, n_in, F], got "
                         f"{tuple(x.shape)}")
    f = x.shape[-1]
    if f % 64 != 0 or f == 0:
        raise ValueError(f"spmm kernel needs F % 64 == 0, got F={f}")
    if op.crow.device != x.device:
        raise ValueError("operator and operand are on different devices")
    if x.shape[-2] != op.n_in:
        raise ValueError(f"operand has {x.shape[-2]} rows, operator takes "
                         f"{op.n_in}")
    out_dtype = _out_dtype(op, x)
    xin = x.to(torch.bfloat16) if op.dtype == torch.bfloat16 else x
    if not _window_ok(xin):
        xin = xin.contiguous()
    b = 1 if x.ndim == 2 else x.shape[0]
    shape = (op.n_out, f) if x.ndim == 2 else (b, op.n_out, f)
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=x.device)
    elif (tuple(out.shape) != shape or out.dtype != out_dtype
          or out.device != x.device or not _window_ok(out)):
        raise ValueError(f"spmm kernel output must be a 16-byte aligned "
                         f"{out_dtype} {shape} window on {x.device}, got "
                         f"{out.dtype} {tuple(out.shape)} strides "
                         f"{out.stride()}")
    bstride = lambda t: t.stride(0) if t.ndim == 3 else 0
    lib = load_library()
    err = lib.gfvgn_spmm_csr(
        op.crow.data_ptr(), op.col.data_ptr(), op.val.data_ptr(),
        xin.data_ptr(), out.data_ptr(),
        b, op.n_in, op.n_out, f,
        xin.stride(-2), bstride(xin), out.stride(-2), bstride(out),
        int(xin.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
