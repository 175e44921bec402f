"""Kernel K1: batched sparse apply out[b] = A · x[b] on the card.

Replaces the TPU kernels of `gen_fvgn_tpu/ops/pallas_spmm.py`:
`pallas_block_spmm_window` (:172, the one the main path runs),
`pallas_block_spmm_binner` (:260), `pallas_block_spmm` (:311) and
`pallas_block_spmm_batched` (:70) — one function, four grids. They stream
256×256 dense tiles of the operator through the matrix unit. The CUDA kernel
(csrc/spmm.cu) computes the same function from the CSR form: a warp per
(output row, batch lane), each lane owning 4 contiguous features of every
128-feature chunk, looping over the row's non-zeros with float32
accumulators and 8- or 16-byte loads.

What bounds it here: bytes. The operators carry a few to a few tens of
non-zeros a row, so the work is a gather-accumulate — the operand is read
once if the gathered rows stay in L2 (the mesh is RCM-ordered, so a row's
neighbours are close by), the output written once, and the float32 FMA
count (2·nnz·B·F) is far below the card's rate.

Tolerance against `spmm_reference`: both accumulate in float32, in a
different order. With the integer weights of the structural operators the
float32 sums can differ in the last bit, which after the cast to bfloat16
is at most one bf16 rounding of the output (2⁻⁸ relative).
"""

from __future__ import annotations

import torch

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0


def spmm_reference(op, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same rounding points: the
    operand is cast to bfloat16 when the operator is stored bfloat16, the
    product accumulates in float32, and the output type follows the
    operand/operator rule. x: [n_in, F] or [B, n_in, F]. Used for CPU
    tensors, and as the yardstick of the kernel on the card."""
    from gen_fvgn_tpu_torch.ops.blocksparse import csr_matmul
    return csr_matmul(op, x)


def spmm(op, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x for x [n_in, F] or [B, n_in, F] with F a multiple of 128.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    `spmm_reference`."""
    if x.device.type != "cuda":
        return spmm_reference(op, x)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    from gen_fvgn_tpu_torch.ops.blocksparse import _out_dtype
    global LAUNCHES
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"spmm kernel takes bfloat16 or float32, got {x.dtype}")
    f = x.shape[-1]
    if f % 128 != 0:
        raise ValueError(f"spmm kernel needs F % 128 == 0, got F={f}")
    if op.crow.device != x.device:
        raise ValueError("operator and operand are on different devices")
    out_dtype = _out_dtype(op, x)
    xin = x.to(torch.bfloat16) if op.dtype == torch.bfloat16 else x
    xin = xin.contiguous()
    b = 1 if x.ndim == 2 else x.shape[0]
    shape = (op.n_out, f) if x.ndim == 2 else (b, op.n_out, f)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    lib = load_library()
    err = lib.gfvgn_spmm_csr(
        op.crow.data_ptr(), op.col.data_ptr(), op.val.data_ptr(),
        xin.data_ptr(), out.data_ptr(),
        b, op.n_in, op.n_out, f,
        int(xin.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
