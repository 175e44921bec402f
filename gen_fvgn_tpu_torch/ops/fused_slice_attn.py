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
from run to run. The nets' shapes (8 heads of 16, 32 or 64, 32 slices) run
its row kernel: projections on the tensor cores into bf16 tiles, a warp a
head with the logits, the softmax and the pooling (w·mask split into bf16
hi + lo against the exact bf16 fx) in mma fragments. Every other shape the
JAX package fuses (`slice_pool_shape_ok`) runs a run-time path (a block a
head, float32 sums on the CUDA cores, K7's dx on the tensor cores with its
operands streamed, so no shared memory grows with C). The backward K7 runs
the block row tiles of csrc/slice_pool_tiles.cuh where their slot mapping
takes the shape, the run-time path otherwise (`slice_pool_plan`).

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
order, and a flipped rounding moves one row's contribution; the row
kernel's hi + lo split of w·mask leaves under 2⁻¹⁶ of it out).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from gen_fvgn_tpu_torch.ops.fused_mlp import (_check, _dot_f32, _ring_bytes,
                                              weight_grad)

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0
LAUNCHES_BWD = 0


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


# what an SM of the H100 holds (cudaDevAttrMaxSharedMemoryPerMultiprocessor);
# each resident block also takes 1 KB of it
SMEM_PER_SM = 233_472


def jax_fuses_slice_pool(c: int, h: int, g: int) -> bool:
    """The JAX package's condition for its fused slice pool
    (`gen_fvgn_tpu/models/transolver.py:63-64`, without its `n % 256`):
    C % 128 == 0, H·G % 128 == 0 and H·D == C."""
    return c >= 128 and c % 128 == 0 and h >= 1 and c % h == 0 and g >= 1 \
        and (h * g) % 128 == 0


def slice_pool_slots(c: int, h: int, g: int):
    """K7's block row tiles' slot mapping for width c, h heads and g slices,
    as csrc/slice_pool_tiles.cuh `pool_shape` gives it: (L lanes a head
    group, heads per group, groups sharing a head, slots a thread, columns
    a thread), or None where the tiles do not take the shape (c up to 512,
    h and g powers of two, g from 8 to 128, a thread's columns 8, 16, 32,
    48 or 64 with at most 64 pooled sums a thread); those shapes run K7's
    run-time path."""
    pow2 = lambda v: v > 0 and v & (v - 1) == 0
    if c < 128 or c % 128 or c > 512 or h < 1 or c % h or (h * g) % 128 \
            or not pow2(g) or not 8 <= g <= 128 or not pow2(h):
        return None
    d = c // h
    lanes = min(g, 32)
    spt, groups = g // lanes, 256 // lanes
    hpg, ds = (h // groups, 1) if h >= groups else (1, groups // h)
    ns = hpg * spt
    if d % ds:
        return None
    dpt = d // ds
    if ns not in (1, 2, 4) or dpt not in (8, 16, 32, 48, 64) \
            or ns * dpt > 64:
        return None
    return lanes, hpg, ds, ns, dpt


def _rows_plan(c: int, h: int, g: int):
    """K6's row kernel (the nets' shapes: 8 heads of 16, 32 or 64, 32
    slices), as csrc/slice_pool_tiles.cuh `pool_run` chooses its tile: two
    blocks an SM before one, weights resident before streamed, larger
    tiles first."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (SMEM_PER_BLOCK, _align128,
                                                  _ring_bytes)
    if not (h == 8 and g == 32 and c in (128, 256, 512)):
        return None
    order = [(resident, per_sm, tm) for per_sm in (2, 1)
             for resident in (True, False) for tm in (64, 32, 16)]
    for resident, per_sm, tm in order:
        size = (_align128(c * (2 * c + 8) * 2 if resident
                          else _ring_bytes(tm))
                + _align128(2 * tm * (c + 8) * 2)
                + 2 * _align128(tm * (c + 8) * 2) + _align128(2 * tm * 4))
        if size <= SMEM_PER_BLOCK and (size + 1024) * per_sm <= SMEM_PER_SM:
            return "rows", tm, resident, per_sm, size
    return None


def _tiles_plan(c: int, h: int, g: int):
    """K7's block row tiles, as `pool_run` chooses them: (tm, weights
    resident, dtokens in shared memory, row buffers, bytes)."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (SMEM_PER_BLOCK, _align128,
                                                  _ring_bytes)
    slots = slice_pool_slots(c, h, g)
    if slots is None:
        return None
    ds, d, hg = slots[2], c // h, h * g
    for resident in (True, False):
        for tm in (64, 32, 16):
            for tok in (True, False):
                for nbuf in (2, 1):
                    if tm * c // 16 > 1024:
                        continue
                    row = _align128(tm * (c + 8) * 2)
                    size = (_align128(2 * c * (c + 8) * 2) if resident
                            else _ring_bytes(tm))
                    size += _align128(nbuf * tm * (c + 8) * 2) + 2 * row
                    size += _align128(hg * (tm + 4) * 4)
                    size += _align128(hg * (tm + 8) * 2)
                    size += _align128(d * (g + 1) * 4 + g * (d + 4) * 4
                                      + d * (g + 8) * 2)
                    size += _align128(hg * (d + 4) * 4) if tok else 0
                    size += _align128(nbuf * tm * (hg + 8) * 2)
                    size = max(size, (2 * ds * hg + 2 * (tm // 4) * c) * 4)
                    if size <= SMEM_PER_BLOCK:
                        return "tiles", tm, resident, tok, nbuf, size
    return None


# K7's run-time dx pass (csrc/fused_slice_pool_bwd.cu `pool_dx`): a block a
# 64-row tile of 128 output columns, two ring slots each holding a
# 32-column chunk of the rows ([64][40] bf16) and of the weight
POOL_DX_SMEM = 2 * 64 * 40 * 2 + _ring_bytes(64)


def _generic_plan(c: int, h: int, g: int, backward: bool):
    """The run-time path of K6 (or K7): the largest tile of 32 to 1 rows
    whose x, the head's fx and xm, w (K7: also l and ds) and the mask fit a
    block; K7's dx pass streams its operands (`POOL_DX_SMEM` at any C)."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import SMEM_PER_BLOCK, _align128
    d = c // h
    tm = next((t for t in (32, 16, 8, 4, 2, 1)
               if _align128(t * c * 2) + 2 * _align128(t * d * 4)
               + (3 if backward else 1) * _align128(t * g * 4)
               + _align128(t * 4) <= SMEM_PER_BLOCK), None)
    if tm is None or (backward and POOL_DX_SMEM > SMEM_PER_BLOCK):
        return None
    return "generic", tm


def slice_pool_plan(c: int, h: int, g: int, backward: bool):
    """How K6 (backward False) or K7 runs width c with h heads and g
    slices, as csrc/slice_pool_tiles.cuh `pool_run` decides it: K6's row
    kernel at the nets' shapes, K7's block row tiles where their slot
    mapping and a tile fit, the run-time path for every other shape the JAX
    package fuses; None outside the JAX package's condition."""
    if not jax_fuses_slice_pool(c, h, g):
        return None
    first = _tiles_plan(c, h, g) if backward else _rows_plan(c, h, g)
    return first or _generic_plan(c, h, g, backward)


def slice_pool_shape_ok(c: int, h: int, g: int) -> bool:
    """Whether K6 and K7 take width c with h heads and g slices (the
    kernels' size query, `gfvgn_slice_pool_workspace`, decides the same on
    the card): every shape the JAX package fuses."""
    return slice_pool_plan(c, h, g, True) is not None \
        and slice_pool_plan(c, h, g, False) is not None


def _pool_operands(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp, what):
    """The checks shared by K6 and K7, raising on what the kernels do not
    take. Returns the operands contiguous, with the mask's batch stride (0
    for a mask [N] shared by the batch) after the mask, and (C, H, G)."""
    bf16, f32 = torch.bfloat16, torch.float32
    c = x.shape[-1]
    d, g = wsl.shape if wsl.ndim == 2 else (0, 0)
    h = c // d if d else 0
    if x.ndim != 3 or not d or c % d or not slice_pool_shape_ok(c, h, g):
        raise NotImplementedError(
            f"{what} takes x [B, N, C] and a [C / H, G] slice kernel with C "
            f"a multiple of 128 and H·G a multiple of 128 (the JAX "
            f"package's condition); got x {tuple(x.shape)}, wsl "
            f"{tuple(wsl.shape)}")
    b, n, _ = x.shape
    if mask.ndim == 1:
        mask, stride = _check(mask, (n,), f32, "mask"), 0
    else:
        mask, stride = _check(mask, (b, n), f32, "mask"), n
    vec = lambda v, k, name: _check(v.reshape(-1), (k,), f32, name)
    return (_check(x, (b, n, c), bf16, "x"), mask, stride,
            _check(wfx, (c, c), bf16, "wfx"), vec(bfx, c, "bfx"),
            _check(wx, (c, c), bf16, "wx"), vec(bx, c, "bx"),
            _check(wsl, (d, g), bf16, "wsl"), vec(bsl, g, "bsl"),
            vec(inv_temp, h, "inv_temp"), (c, h, g))


def _pool_workspace(lib, shape, b, n, backward, dev, what):
    """The kernels' workspace (partials; for K7 also the dfx16/dxm16 rows
    and the weight-gradient partials), freed when the call returns."""
    nbytes = lib.gfvgn_slice_pool_workspace(*shape, b, n, int(backward))
    if nbytes < 0:
        raise NotImplementedError(f"{what}: no kernel takes (C, H, G) = "
                                  f"{shape}")
    return torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)


def fused_slice_pool_kernel(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp):
    """K6 on prepared operands (see `fused_slice_pool_reference`), bf16
    stream, the shape by `slice_pool_shape_ok`.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_slice_pool_reference`."""
    global LAUNCHES
    if x.device.type != "cuda":
        return fused_slice_pool_reference(x, mask, wfx, bfx, wx, bx, wsl, bsl,
                                          inv_temp)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    bf16, f32 = torch.bfloat16, torch.float32
    what = "fused_slice_pool kernel"
    x, mask, stride, wfx, bfx, wx, bx, wsl, bsl, inv_temp, shape = \
        _pool_operands(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp, what)
    (b, n, c), (_, h, g) = x.shape, shape
    dev = x.device
    lib = load_library()
    with torch.cuda.device(dev):
        ws = _pool_workspace(lib, shape, b, n, False, dev, what)
        slice_w = torch.empty((b, n, h * g), dtype=bf16, device=dev)
        tokens = torch.empty((b, h, g, c // h), dtype=f32, device=dev)
        norm = torch.empty((b, h, g), dtype=f32, device=dev)
        err = lib.gfvgn_fused_slice_pool(
            x.data_ptr(), mask.data_ptr(), stride, wfx.data_ptr(),
            bfx.data_ptr(), wx.data_ptr(), bx.data_ptr(), wsl.data_ptr(),
            bsl.data_ptr(), inv_temp.data_ptr(), slice_w.data_ptr(),
            tokens.data_ptr(), norm.data_ptr(), c, h, g, b, n, ws.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
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
    (see `fused_slice_pool_bwd_reference`). Three launches: the row pass,
    the weight-gradient pass and the fixed-order reductions, over a
    workspace of bf16 rows (dfx16, dxm16: 2 [B, N, C] streams) and float32
    partials freed on return.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_slice_pool_bwd_reference`."""
    global LAUNCHES_BWD
    if x.device.type != "cuda":
        return fused_slice_pool_bwd_reference(
            x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp, dslice_w,
            dtokens, dnorm)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    bf16, f32 = torch.bfloat16, torch.float32
    what = "fused_slice_pool backward kernel"
    x, mask, stride, wfx, bfx, wx, bx, wsl, bsl, inv_temp, shape = \
        _pool_operands(x, mask, wfx, bfx, wx, bx, wsl, bsl, inv_temp, what)
    (b, n, c), (_, h, g) = x.shape, shape
    d = c // h
    dslice_w = _check(dslice_w, (b, n, h * g), bf16, "dslice_w")
    dtokens = _check(dtokens, (b, h, g, d), f32, "dtokens")
    dnorm = _check(dnorm, (b, h, g), f32, "dnorm")
    dev = x.device
    cc, hdg, hg = c * c, h * d * g, h * g
    lib = load_library()
    with torch.cuda.device(dev):
        ws = _pool_workspace(lib, shape, b, n, True, dev, what)
        dx = torch.empty((b, n, c), dtype=bf16, device=dev)
        total = torch.empty((2 * cc + hdg + 2 * hg + 2 * c,), dtype=f32,
                            device=dev)
        err = lib.gfvgn_fused_slice_pool_bwd(
            x.data_ptr(), mask.data_ptr(), stride, wfx.data_ptr(),
            bfx.data_ptr(), wx.data_ptr(), bx.data_ptr(), wsl.data_ptr(),
            bsl.data_ptr(), inv_temp.data_ptr(), dslice_w.data_ptr(),
            dtokens.data_ptr(), dnorm.data_ptr(), dx.data_ptr(),
            total.data_ptr(), c, h, g, b, n, ws.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    LAUNCHES_BWD += 1
    # the summed slab: dWfx | dWx [C, C] | dWsl per head [H, D, G] |
    # dbsl per slot [H, G] | dinv_temp per slot [H, G] | dbfx | dbx [C]
    o = [0, cc, 2 * cc, 2 * cc + hdg, 2 * cc + hdg + hg, 2 * cc + hdg + 2 * hg,
         2 * cc + hdg + 2 * hg + c, 2 * cc + hdg + 2 * hg + 2 * c]
    seg = lambda i: total[o[i]:o[i + 1]]
    return SlicePoolGrads(
        dx=dx, dwfx=seg(0).reshape(c, c).to(bf16), dbfx=seg(5),
        dwx=seg(1).reshape(c, c).to(bf16), dbx=seg(6),
        dwsl_heads=seg(2).reshape(h, d, g).to(bf16),
        dbsl=seg(3).reshape(h, g).sum(dim=0),
        dinv_temp=seg(4).reshape(h, g).sum(dim=1))


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
