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
from typing import NamedTuple, Tuple

import torch

from gen_fvgn_tpu_torch.ops.fused_mlp import _check, _dot_f32, weight_grad

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0
LAUNCHES_BWD = 0

_C, _H, _D, _G = 128, 8, 16, 32      # the shape the CUDA kernels are built for
_TILE = 64                           # K6's row tile
_BWD_TILE = 32                       # K7's row tile
# floats of one K7 block's partial slab (csrc/fused_slice_pool.cu)
_BWD_PART = 2 * _C * _C + _H * _D * _G + 2 * _H * _G + 2 * _C


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


def _chunks(n: int, batch: int, n_sm: int, tile: int = _TILE
            ) -> Tuple[int, int]:
    """(rows_per_chunk, n_chunks): about two blocks per SM over the batch,
    each chunk a whole number of `tile`-row tiles."""
    tiles = -(-n // tile)
    want = max(1, min(tiles, (2 * n_sm) // max(batch, 1)))
    rows = -(-tiles // want) * tile
    return rows, -(-n // rows)


def _pool_operands(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp, what):
    """The checks shared by K6 and K7, raising on what the kernels do not
    take. Returns the operands contiguous, with the mask's batch stride (0
    for a mask [N] shared by the batch) after the mask."""
    bf16, f32 = torch.bfloat16, torch.float32
    if x.ndim != 3 or x.shape[2] != _C or tuple(wsl.shape) != (_D, _G):
        raise NotImplementedError(
            f"{what} is built for x [B, N, {_C}] and a [{_D}, {_G}] slice "
            f"kernel, got x {tuple(x.shape)}, wsl {tuple(wsl.shape)}")
    b, n, _ = x.shape
    if mask.ndim == 1:
        mask, stride = _check(mask, (n,), f32, "mask"), 0
    else:
        mask, stride = _check(mask, (b, n), f32, "mask"), n
    vec = lambda v, k, name: _check(v.reshape(-1), (k,), f32, name)
    return (_check(x, (b, n, _C), bf16, "x"), mask, stride,
            _check(wfx, (_C, _C), bf16, "wfx"), vec(bfx, _C, "bfx"),
            _check(wx, (_C, _C), bf16, "wx"), vec(bx, _C, "bx"),
            _check(wsl, (_D, _G), bf16, "wsl"), vec(bsl, _G, "bsl"),
            vec(inv_temp, _H, "inv_temp"))


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
    x, mask, stride, wfx, bfx, wx, bx, wsl, bsl, inv_temp = _pool_operands(
        x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp,
        "fused_slice_pool kernel")
    b, n, _ = x.shape
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


class SlicePoolGrads(NamedTuple):
    """Gradients of `fused_slice_pool` (K7's outputs) on prepared operands:
    dx in the stream type; dwfx, dwx [C, C] and the per-head blocks
    dwsl_heads [H, D, G] rounded to the weights' type (bf16); dbfx, dbx
    [C], dbsl [G] and dinv_temp [H] float32."""
    dx: torch.Tensor
    dwfx: torch.Tensor
    dbfx: torch.Tensor
    dwx: torch.Tensor
    dbx: torch.Tensor
    dwsl_heads: torch.Tensor
    dbsl: torch.Tensor
    dinv_temp: torch.Tensor


def fused_slice_pool_bwd_reference(x, mask, wfx, bfx, wx, bx, wsl, bsl,
                                   inv_temp, dslice_w, dtokens, dnorm
                                   ) -> SlicePoolGrads:
    """Plain PyTorch version of K7 on the operands of
    `fused_slice_pool_reference` and the cotangents dslice_w [B, N, H·G]
    (stream type), dtokens [B, H, G, D] and dnorm [B, H, G] (float32).

    The rounding points of the JAX kernel `_make_bwd_kernel` (:170-236):
    the slice weights are recomputed in float32 from x (the stored bf16
    slice_w is never read); the pooling backward (dfx, dw_m) and the
    softmax backward in float32; dl = ds·inv_temp, dfx and dxm rounded to
    bf16 before the products that take them; the inverse-temperature
    cotangent Σ ds·l in float32. JAX's dWsl is the bf16 cotangent of
    kron(eye(H), wsl) cast to bf16, whose backward sums the H diagonal
    [D, G] blocks in float32: the blocks are returned per head, rounded,
    for that sum. Each graph of the batch is one lane of the JAX vmap, so
    the weight gradients are rounded per graph and then summed (see
    `weight_grad`)."""
    f32, dt = torch.float32, x.dtype
    b, n, c = x.shape
    d, g = wsl.shape
    h = c // d
    fx16 = (_dot_f32(x, wfx) + bfx.to(f32)).to(dt)
    xm16 = (_dot_f32(x, wx) + bx.to(f32)).to(dt)
    l32 = (_dot_f32(xm16.reshape(b, n, h, d), wsl)
           + bsl.to(f32)).to(dt).to(f32)                      # [B,N,H,G]
    it = inv_temp.to(f32).reshape(h, 1)
    s = l32 * it
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    m = mask.to(f32).reshape(-1, n, 1, 1)
    w_m = w * m
    dtok = dtokens.to(f32)
    dfx = torch.einsum("bnhg,bhgd->bnhd", w_m, dtok).reshape(b, n, c)
    dw_m = torch.einsum("bnhd,bhgd->bnhg",
                        fx16.to(f32).reshape(b, n, h, d), dtok) \
        + dnorm.to(f32)[:, None]
    dw_all = dslice_w.to(dt).to(f32).reshape(b, n, h, g) + dw_m * m
    inner = (w * dw_all).sum(dim=-1, keepdim=True)
    ds = w * (dw_all - inner)
    dinv_temp = (ds * l32).sum(dim=(0, 1, 3))
    dl = ds * it
    dl16 = dl.to(dt)
    per_lane = torch.einsum("bnhd,bnhg->bhdg",
                            xm16.to(f32).reshape(b, n, h, d), dl16.to(f32))
    dwsl_heads = per_lane.to(wsl.dtype).to(f32).sum(dim=0).to(wsl.dtype)
    dxm = torch.einsum("bnhg,dg->bnhd", dl16.to(f32),
                       wsl.to(f32)).reshape(b, n, c)
    dfx16, dxm16 = dfx.to(dt), dxm.to(dt)
    rows = lambda t: t.reshape(-1, c)
    dwfx = weight_grad(rows(x), rows(dfx16), b, wfx.dtype)
    dwx = weight_grad(rows(x), rows(dxm16), b, wx.dtype)
    dx = (_dot_f32(dfx16, wfx.t()) + _dot_f32(dxm16, wx.t())).to(dt)
    return SlicePoolGrads(
        dx=dx, dwfx=dwfx, dbfx=dfx.sum(dim=(0, 1)), dwx=dwx,
        dbx=dxm.sum(dim=(0, 1)), dwsl_heads=dwsl_heads,
        dbsl=dl.sum(dim=(0, 1, 2)), dinv_temp=dinv_temp)


def fused_slice_pool_bwd_kernel(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp,
                                dslice_w, dtokens, dnorm) -> SlicePoolGrads:
    """K7 on the operands of `fused_slice_pool_kernel` and the cotangents
    (see `fused_slice_pool_bwd_reference`).

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_slice_pool_bwd_reference`."""
    global LAUNCHES_BWD
    if x.device.type != "cuda":
        return fused_slice_pool_bwd_reference(
            x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp, dslice_w,
            dtokens, dnorm)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    bf16, f32 = torch.bfloat16, torch.float32
    x, mask, stride, wfx, bfx, wx, bx, wsl, bsl, inv_temp = _pool_operands(
        x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp,
        "fused_slice_pool backward kernel")
    b, n, _ = x.shape
    dslice_w = _check(dslice_w, (b, n, _H * _G), bf16, "dslice_w")
    dtokens = _check(dtokens, (b, _H, _G, _D), f32, "dtokens")
    dnorm = _check(dnorm, (b, _H, _G), f32, "dnorm")
    dev = x.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, n_chunks = _chunks(n, b, n_sm, _BWD_TILE)
    dx = torch.empty((b, n, _C), dtype=bf16, device=dev)
    part = torch.empty((b * n_chunks, _BWD_PART), dtype=f32, device=dev)
    total = torch.empty((_BWD_PART,), dtype=f32, device=dev)
    err = load_library().gfvgn_fused_slice_pool_bwd(
        x.data_ptr(), mask.data_ptr(), stride, wfx.data_ptr(),
        bfx.data_ptr(), wx.data_ptr(), bx.data_ptr(), wsl.data_ptr(),
        bsl.data_ptr(), inv_temp.data_ptr(), dslice_w.data_ptr(),
        dtokens.data_ptr(), dnorm.data_ptr(), dx.data_ptr(),
        part.data_ptr(), total.data_ptr(), b, n, rows, n_chunks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_slice_pool backward kernel launch failed: CUDA error "
            f"{err}")
    LAUNCHES_BWD += 1
    # the summed slab: dWfx | dWx [C, C] | dWsl per head [H, D, G] |
    # dbsl per head [H, G] | dinv_temp per slice [H, G] | dbfx | dbx [C]
    cc, hdg, hg = _C * _C, _H * _D * _G, _H * _G
    o = [0, cc, 2 * cc, 2 * cc + hdg, 2 * cc + hdg + hg, 2 * cc + hdg + 2 * hg,
         2 * cc + hdg + 2 * hg + _C, _BWD_PART]
    seg = lambda i: total[o[i]:o[i + 1]]
    return SlicePoolGrads(
        dx=dx, dwfx=seg(0).reshape(_C, _C).to(bf16), dbfx=seg(5),
        dwx=seg(1).reshape(_C, _C).to(bf16), dbx=seg(6),
        dwsl_heads=seg(2).reshape(_H, _D, _G).to(bf16),
        dbsl=seg(3).reshape(_H, _G).sum(dim=0),
        dinv_temp=seg(4).reshape(_H, _G).sum(dim=1))


class _SlicePoolFn(torch.autograd.Function):
    """K6 forward, K7 backward (or their plain versions when `plain` was
    set at the forward). Takes the caller's parameters as they are and
    casts them here, so that the gradient of the shared slice kernel can be
    the float32 sum of the H rounded per-head blocks (a bf16 input would
    round that sum once more)."""

    @staticmethod
    def forward(ctx, plain, x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp):
        dt, f32 = x.dtype, torch.float32
        ops = (x, mask, wfx.to(dt), bfx.to(f32), wx.to(dt), bx.to(f32),
               wsl.to(dt), bsl.to(f32), inv_temp.to(f32))
        ctx.plain = plain
        ctx.dtypes = tuple(t.dtype for t in (wfx, bfx, wx, bx, wsl, bsl,
                                             inv_temp))
        ctx.save_for_backward(*ops)
        fn = fused_slice_pool_reference if plain else fused_slice_pool_kernel
        return fn(*ops)

    @staticmethod
    def backward(ctx, dslice_w, dtokens, dnorm):
        ops = ctx.saved_tensors
        fn = (fused_slice_pool_bwd_reference if ctx.plain
              else fused_slice_pool_bwd_kernel)
        gr = fn(*ops, dslice_w.to(ops[0].dtype).contiguous(),
                dtokens.to(torch.float32).contiguous(),
                dnorm.to(torch.float32).contiguous())
        dwsl = gr.dwsl_heads.to(torch.float32).sum(dim=0)
        grads = (gr.dwfx, gr.dbfx, gr.dwx, gr.dbx, dwsl, gr.dbsl,
                 gr.dinv_temp)
        return (None, gr.dx, None,
                *(t.to(dtype) for t, dtype in zip(grads, ctx.dtypes)))


def fused_slice_pool(x, node_mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp,
                     heads: int, slice_num: int):
    """Slice-attention pooling for a batch of graphs (counterpart of the JAX
    function of the same name, which takes one graph and the block-diagonal
    [C, H·G] embed of the slice kernel), differentiable: K6 forward, K7
    backward.

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
    # the mask passes through the stream type, as in the JAX wrapper
    mask = node_mask.to(x.dtype).to(torch.float32)
    return _SlicePoolFn.apply(plain_versions_active(), x, mask, wfx, bfx, wx,
                              bx, wsl, bsl, inv_temp)
