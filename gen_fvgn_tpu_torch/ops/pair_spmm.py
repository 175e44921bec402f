"""Kernels K8 and K9: the paired sparse applies on the card.

    pair_sum(A, B, y)        out[b] = A · y[b][:, :H] + B · y[b][:, H:]
    pair_transpose(A, B, g)  out[b] = [A · g[b] | B · g[b]]

K8 replaces `gen_fvgn_tpu/ops/pallas_spmm.py::pallas_gather_pair` (:419,
`pallas_call` at :484), K9 `pallas_pair_transpose` (:503, `pallas_call` at
:574). Those stream the 256×256 dense tiles of two operators through the
matrix unit over one union window of the operand. The CUDA kernels
(csrc/pair_spmm.cu) compute the same functions from the two CSR operators,
in float32 FMAs.

K8 is K1's design (csrc/spmm_rows.cuh, shared with K1): a warp owns an
output row for all batch lanes, loads the indices of A's row and B's row
once as one list (A's non-zeros, then B's) and broadcasts them by shuffles,
and each lane keeps eight independent loads in flight, of 16 bytes where H
and the addresses allow it (8, 4 or 2 bytes otherwise: any H, any
address). K9 runs the same rows in their split form: one index list for A
and B, each operator's products in its own accumulators and its own half
of the output row, the same vector widths, so neither wrapper copies an
unaligned operand.

K8 serves two uses: the EdgeBlock's gather pair (one-hot `gather_s` /
`gather_r`, H = hidden) and the NodeBlock's pair sum (`nbr_r` / `nbr_s`,
H = hidden / 2). K9 is the node pair's backward on the stored transposes
`nbr_r.bwd` / `nbr_s.bwd`.

What bounds them here: bytes, as K1. The operators carry one (gathers) to a
few tens (nbr) of non-zeros a row, so the work is a gather-accumulate: the
operand read once if the gathered rows stay in L2, the output written once,
and the float32 FMA count far below the card's rate.

Rounding: K8 sums both operators' products into ONE float32 accumulator per
output element and rounds once, so its plain version adds the two float32
products before its single rounding — it is not
`csr_matmul(A, ·) + csr_matmul(B, ·)`, which rounds three times. K9 rounds
each half once. Against the plain versions both differ only by the order of
float32 sums: at most one rounding of the output type, plus float32
round-off of the order of 2⁻²³ of the sum of the magnitudes (the node
pair's operands have mixed signs, so a sum may cancel).

Types, the rule of `blocksparse._out_dtype` and `spmm`: the operand is cast
to bfloat16 when the operators are stored bfloat16; the output is bfloat16
for a bfloat16 operand and bfloat16 operators, float32 otherwise, unless
the caller names `out_dtype` (the JAX callers give their kernels the type
of the cast operand).
"""

from __future__ import annotations

from typing import Optional

import torch

# incremented once per kernel launch, and nowhere else
LAUNCHES_PAIR_SUM = 0
LAUNCHES_PAIR_TRANSPOSE = 0


def _operand(a, b, x: torch.Tensor, out_dtype: Optional[torch.dtype]):
    """(operand cast as the operators ask, output type)."""
    from gen_fvgn_tpu_torch.ops.blocksparse import _out_dtype
    if a.n_out != b.n_out or a.n_in != b.n_in or a.dtype != b.dtype:
        raise ValueError("a pair takes two operators of one shape and type")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the pair applies take bfloat16 or float32, got "
                        f"{x.dtype}")
    if x.ndim not in (2, 3) or x.shape[-2] != a.n_in:
        raise ValueError(f"operand {tuple(x.shape)} does not fit an operator "
                         f"taking {a.n_in} rows")
    xin = x.to(torch.bfloat16) if a.dtype == torch.bfloat16 else x
    return xin, out_dtype or _out_dtype(a, x)


def pair_sum_reference(a, b, y: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of K8: y [(B,) n_in, 2H] -> [(B,) n_out, H],
    the two float32 products added before one rounding."""
    from gen_fvgn_tpu_torch.ops.blocksparse import csr_matmul_f32
    xin, out_dtype = _operand(a, b, y, out_dtype)
    h = y.shape[-1] // 2
    out = csr_matmul_f32(a, xin[..., :h]) + csr_matmul_f32(b, xin[..., h:])
    return out.to(out_dtype)


def pair_transpose_reference(a, b, g: torch.Tensor,
                             out_dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of K9: g [(B,) n_in, H] -> [(B,) n_out, 2H],
    each half rounded once."""
    from gen_fvgn_tpu_torch.ops.blocksparse import csr_matmul_f32
    xin, out_dtype = _operand(a, b, g, out_dtype)
    return torch.cat([csr_matmul_f32(a, xin), csr_matmul_f32(b, xin)],
                     dim=-1).to(out_dtype)


def _launch(fn_name, a, b, xin, out_dtype, h, out_width):
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{fn_name} gives bfloat16 or float32, not "
                        f"{out_dtype}")
    if a.crow.device != xin.device or b.crow.device != xin.device:
        raise ValueError("operators and operand are on different devices")
    xin = xin.contiguous()
    nb = 1 if xin.ndim == 2 else xin.shape[0]
    shape = (a.n_out, out_width) if xin.ndim == 2 \
        else (nb, a.n_out, out_width)
    out = torch.empty(shape, dtype=out_dtype, device=xin.device)
    err = getattr(load_library(), fn_name)(
        a.crow.data_ptr(), a.col.data_ptr(), a.val.data_ptr(),
        b.crow.data_ptr(), b.col.data_ptr(), b.val.data_ptr(),
        xin.data_ptr(), out.data_ptr(), nb, a.n_in, a.n_out, h,
        int(xin.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(xin.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
    return out


def pair_sum(a, b, y: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K8: out = A · y[..., :H] + B · y[..., H:] for y [(B,) n_in, 2H].

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    `pair_sum_reference`."""
    if y.device.type != "cuda":
        return pair_sum_reference(a, b, y, out_dtype)
    global LAUNCHES_PAIR_SUM
    if y.shape[-1] % 2 != 0:
        raise ValueError(f"pair_sum needs an even width, got {y.shape[-1]}")
    xin, out_dtype = _operand(a, b, y, out_dtype)
    h = y.shape[-1] // 2
    out = _launch("gfvgn_pair_sum", a, b, xin, out_dtype, h, h)
    LAUNCHES_PAIR_SUM += 1
    return out


def pair_transpose(a, b, g: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K9: out = [A · g | B · g] for g [(B,) n_in, H].

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    `pair_transpose_reference`."""
    if g.device.type != "cuda":
        return pair_transpose_reference(a, b, g, out_dtype)
    global LAUNCHES_PAIR_TRANSPOSE
    xin, out_dtype = _operand(a, b, g, out_dtype)
    h = g.shape[-1]
    out = _launch("gfvgn_pair_transpose", a, b, xin, out_dtype, h, 2 * h)
    LAUNCHES_PAIR_TRANSPOSE += 1
    return out
