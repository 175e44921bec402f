"""Kernel K6: the per-node half of physics attention (slice-attention
pooling), forward.

Counterpart of `gen_fvgn_tpu/ops/fused_slice_attn.py`. K6 replaces its TPU
kernel `_make_fwd_kernel` (core `_slice_core` :117-140, kernel :143-167,
called at :274). For every node of a graph it computes the two input
projections fx and xm, the slice logits of each head, the per-head
temperature softmax over the G slices, and pools the masked slice weights
and fx into per-head slice tokens and their norms.

The TPU kernel takes the shared [D, G] slice kernel as a block-diagonal
[C, H·G] embed and pools the FULL cross-head [H·G, C] product, whose
off-diagonal blocks the model throws away. The CUDA kernel
(csrc/fused_slice_pool.cu) takes the shared [D, G] kernel, the [G] bias and
one inverse temperature per head, and produces only the per-head diagonal
blocks: tokens [B, H, G, D] and norm [B, H, G]. Rows of a batch lane are
cut into chunks pooled by separate blocks; a second pass in the same file
sums the chunks' partials in a fixed order, so the result is the same bits
from run to run.

Rounding points, identical in the kernel and in the plain version: fx, xm
and the logits rounded to the stream type (bf16) after a float32-accumulated
product plus bias; logits·inv_temp, the exact-max-shifted exp and the
normalisation in float32; slice_w stored bf16; the pooling takes float32
w·mask and float32 fx.

Tolerance kernel vs plain version: the float32 sums of the projections are
taken in another order, which can flip one bf16 rounding of fx, xm or a
logit. A flipped logit moves all G weights of its (node, head) by up to a
factor e^(±2δ), δ = inv_temp · ulp(logit): `slice_w_tolerance`. Tokens and
norm within 1e-3 of their scale (the float32 pooling sums run in another
order, and a flipped rounding moves one row's contribution).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gen_fvgn_tpu_torch.ops.fused_mlp import _check, _dot_f32

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0

_C, _H, _D, _G = 128, 8, 16, 32      # the shape the CUDA kernel is built for
_TILE = 64                           # its row tile


def slice_logits(x, wx, bx, wsl, bsl) -> torch.Tensor:
    """The slice logits [B, N, H, G] of the plain version, in the stream
    type: xm = x·Wx + bx and xm_h·Wsl + bsl, each accumulated in float32
    and rounded once."""
    b, n, c = x.shape
    d = wsl.shape[0]
    xm = (_dot_f32(x, wx) + bx.to(torch.float32)).to(x.dtype)
    return (_dot_f32(xm.reshape(b, n, c // d, d), wsl)
            + bsl.to(torch.float32)).to(x.dtype)


def slice_w_tolerance(logit_absmax: float, inv_temp_max: float) -> float:
    """The largest |kernel − plain version| of a slice weight. One flipped
    bf16 rounding of a logit l moves l·inv_temp by δ = inv_temp·ulp(l), so
    the G weights of that node and head move by a factor within e^(±2δ)
    (the normaliser moves the other way): at most e^(2δ) − 1 for a weight
    ≤ 1; plus one rounding of the stored weight, 2⁻⁸."""
    ulp = 2.0 ** (math.floor(math.log2(max(logit_absmax, 2.0 ** -100))) - 7)
    return math.expm1(2.0 * inv_temp_max * ulp) + 2.0 ** -8


def fused_slice_pool_reference(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch version of K6 on prepared operands.

    x [B, N, C] in the stream type; mask [B, N] or [N] float32; wfx, wx
    [C, C] and wsl [D, G] in the stream type; bfx, bx [C], bsl [G] and
    inv_temp [H] float32, with H = C // D.

    Returns slice_w [B, N, H·G] (stream type), tokens [B, H, G, D] and
    norm [B, H, G] (float32)."""
    f32, dt = torch.float32, x.dtype
    b, n, c = x.shape
    d, g = wsl.shape
    h = c // d
    fx = (_dot_f32(x, wfx) + bfx.to(f32)).to(dt)
    l16 = slice_logits(x, wx, bx, wsl, bsl)                   # [B,N,H,G]
    s = l16.to(f32) * inv_temp.to(f32).reshape(h, 1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    w_m = w * mask.to(f32).reshape(-1, n, 1, 1)
    tokens = torch.einsum("bnhg,bnhd->bhgd", w_m,
                          fx.to(f32).reshape(b, n, h, d))
    return w.reshape(b, n, h * g).to(dt), tokens, w_m.sum(dim=1)


def _chunks(n: int, batch: int, n_sm: int) -> Tuple[int, int]:
    """(rows_per_chunk, n_chunks): about two blocks per SM over the batch,
    each chunk a whole number of row tiles."""
    tiles = -(-n // _TILE)
    want = max(1, min(tiles, (2 * n_sm) // max(batch, 1)))
    rows = -(-tiles // want) * _TILE
    return rows, -(-n // rows)


def fused_slice_pool_kernel(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp):
    """K6 on prepared operands (see `fused_slice_pool_reference`); the
    kernel is built for C = 128, D = 16, G = 32 (so H = 8) with a bf16
    stream.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_slice_pool_reference`."""
    global LAUNCHES
    if x.device.type != "cuda":
        return fused_slice_pool_reference(x, mask, wfx, bfx, wx, bx, wsl, bsl,
                                          inv_temp)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    bf16, f32 = torch.bfloat16, torch.float32
    if x.ndim != 3 or x.shape[2] != _C or tuple(wsl.shape) != (_D, _G):
        raise NotImplementedError(
            f"fused_slice_pool kernel is built for x [B, N, {_C}] and a "
            f"[{_D}, {_G}] slice kernel, got x {tuple(x.shape)}, wsl "
            f"{tuple(wsl.shape)}")
    b, n, _ = x.shape
    x = _check(x, (b, n, _C), bf16, "x")
    if mask.ndim == 1:
        mask, stride = _check(mask, (n,), f32, "mask"), 0
    else:
        mask, stride = _check(mask, (b, n), f32, "mask"), n
    wfx = _check(wfx, (_C, _C), bf16, "wfx")
    wx = _check(wx, (_C, _C), bf16, "wx")
    wsl = _check(wsl, (_D, _G), bf16, "wsl")
    bfx = _check(bfx.reshape(-1), (_C,), f32, "bfx")
    bx = _check(bx.reshape(-1), (_C,), f32, "bx")
    bsl = _check(bsl.reshape(-1), (_G,), f32, "bsl")
    inv_temp = _check(inv_temp.reshape(-1), (_H,), f32, "inv_temp")
    dev = x.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, n_chunks = _chunks(n, b, n_sm)
    slice_w = torch.empty((b, n, _H * _G), dtype=bf16, device=dev)
    part = torch.empty((b, n_chunks, _H * _G * (_D + 1)), dtype=f32,
                       device=dev)
    tokens = torch.empty((b, _H, _G, _D), dtype=f32, device=dev)
    norm = torch.empty((b, _H, _G), dtype=f32, device=dev)
    err = load_library().gfvgn_fused_slice_pool(
        x.data_ptr(), mask.data_ptr(), stride, wfx.data_ptr(),
        bfx.data_ptr(), wx.data_ptr(), bx.data_ptr(), wsl.data_ptr(),
        bsl.data_ptr(), inv_temp.data_ptr(), slice_w.data_ptr(),
        part.data_ptr(), tokens.data_ptr(), norm.data_ptr(), b, n, rows,
        n_chunks, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_slice_pool kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return slice_w, tokens, norm


def fused_slice_pool(x, node_mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp,
                     heads: int, slice_num: int):
    """Slice-attention pooling for a batch of graphs (counterpart of the JAX
    function of the same name, which takes one graph and the block-diagonal
    [C, H·G] embed of the slice kernel).

    x: [B, N, C]; node_mask: [N] (shared by the batch) or [B, N], any type;
    wfx/wx: [C, C]; wsl: the shared [D, G] slice kernel; bfx/bx: [C];
    bsl: [G]; inv_temp: [H] (1 / graph_temperature).

    Returns (slice_w [B, N, H·G] in x's type, tokens [B, H, G, D] float32
    — the per-head diagonal blocks of the JAX `tok_full` — and norm
    [B, H, G] float32 = Σ_n masked slice_w)."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    if tuple(wsl.shape) != (x.shape[-1] // heads, slice_num):
        raise ValueError(f"wsl must be [{x.shape[-1] // heads}, "
                         f"{slice_num}], got {tuple(wsl.shape)}")
    dt, f32 = x.dtype, torch.float32
    # the mask passes through the stream type, as in the JAX wrapper
    mask = node_mask.to(dt).to(f32)
    fn = (fused_slice_pool_reference if plain_versions_active()
          else fused_slice_pool_kernel)
    return fn(x, mask, wfx.to(dt), bfx.to(f32), wx.to(dt), bx.to(f32),
              wsl.to(dt), bsl.to(f32), inv_temp.to(f32))
