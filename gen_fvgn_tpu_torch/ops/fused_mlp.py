"""Kernels K2, K4f and K5f, the fused GELU MLP chains, and their backward
kernels K3, K4b and K5b.

K2 `fused_mlp_ln` replaces the TPU kernel `_make_fwd_kernel`
(`gen_fvgn_tpu/ops/fused_mlp.py:98-126`, called at :385):

    LN(W3·gelu(W2·gelu(Σ xᵢ·W1ᵢ + Σ pres + b1) + b2) + b3)·γ + β

with the first layer's input given as PARTS (the concatenation never
exists in device memory), `pres` inputs already projected into the first
hidden basis, and an optional residual epilogue: `res_idx` names the part
to add; with `res_dual` both `out` and `out + part` are written, otherwise
only the sum.

K4f `fused_mlp_noln` replaces `_noln_fwd_kernel` (:915-921, called at :960),
the same chain without LayerNorm for the decoder. The TPU wrapper pads the
3-wide head to 128 lanes; the CUDA kernel writes the 3 real columns.

Widths: any hidden width H that is a multiple of 128 (the LayerNorm as
wide), part widths that are multiples of 16 below 128 or multiples of 128
(`part_width_ok`: JAX's `k % 128 == 0 or k < 128`), a head of at most 16
columns without LayerNorm; `_mlp_operands` raises on anything else (the
wrapper `fused_mlp_ln_parts` first zero-pads a part wider than 128 to the
next multiple of 128, as the JAX wrapper does), and
the kernel library on a shape whose tile does not fit a block's shared
memory (`gfvgn_fused_mlp_workspace`).

Both are kernels of csrc/fused_mlp.cu, products on the tensor cores
(mma.sync m16n8k16, bf16 in, float32 accumulators) in the kernels' own
bodies. At H = 128 (`fused_mlp_fwd_rows`) a block stages W1, W2, W3 once and
each warp walks over its own 16-row strips: a 16 × 128 accumulator whose
fragments feed the next product as bf16 registers (h1, h2 never touch
shared memory), LayerNorm by quad shuffles, no block barrier after the
staging, the next strip's rows in flight by cp.async. Wider H
(`fused_mlp_fwd_tiles`) takes 64-, 32- or 16-row tiles shared by 8 warps,
h1/h2 in shared memory, weights resident while they fit and streamed in
32-row chunks through a 3-stage cp.async ring otherwise.

What bounds them here: bytes. A row costs ~131 k FLOP against ~1 KB moved
at H = 128, under the card's ~295 FLOP/byte ridge; the times stand in
PERF.md.

Rounding points, identical in the kernel and in the plain versions below:
float32 accumulation in each product; h1 and h2 rounded to bf16 before the
next product; biases, pres, GELU (tanh form) and LayerNorm statistics (fast
variance clamped at 0, eps 1e-6) in float32; `out` rounded to bf16 BEFORE
the residual add, which is a bf16 add.

K5f `fused_premlp_res` replaces `_premlp_fwd_kernel` (:691-711, called at
:747), the Transolver block's pre-LN MLP branch with its residual:

    out = x + W2·gelu(W1·(LN(x)·γ + β) + b1) + b2,   hidden width 2C

in its own kernels (csrc/fused_premlp.cu), at any width C that is a
multiple of 128 (`premlp_shape_ok`; at C = 128 the forward on K2's row
design, a warp a 16-row strip with u, h and y in registers, the backward
on block row tiles; every wider C as passes through device memory, each
product a block's 64 × 128 tile with both operands streamed,
`premlp_plan`): the LayerNorm
comes first and its rounding points differ from K2's: u = LN(x)·γ + β is
rounded to bf16 before W1, h before W2, and the residual x is added in
float32 BEFORE the one final bf16 rounding (K2 rounds first and adds in
bf16).

Tolerance kernel vs plain version: the float32 sums are taken in another
order (tensor-core fragments vs a library GEMM), and the kernels' GELU
(x·sigmoid(2u) on a fast exp and reciprocal, csrc/mma_sm90.cuh, shared by
every MLP kernel) and sqrtf differ in the last bits from PyTorch's, which
can move a bf16 rounding of h1, h2 or the output by one step: 2 bf16 ulps
of the output scale.

The backward kernels (K3 `fused_mlp_ln_bwd`, K4b `fused_mlp_noln_bwd`, K5b
`fused_premlp_res_bwd`) replace `_make_bwd_kernel` (:129-228, called at
:421), `_noln_bwd_kernel` (:924-952, called at :980) and
`_premlp_bwd_kernel` (:714-740, called at :766). Each recomputes the
forward from the saved inputs (remat, as the TPU kernels do), rounds dy,
dh2pre and dh1pre to bf16 before the products that take them, runs the
LayerNorm backward in float32, and returns the weight gradients rounded to
the weights' type (bf16) after one float32 sum per batch lane; biases, γ
and β get float32 gradients. No float atomics: two runs give the same
bits. K3/K4b run as two passes: the row pass (`fused_mlp_bwd_rows` at H = 128,
`fused_mlp_bwd_tiles` wider) recomputes the forward once per tile, writes dx,
dpre and the bf16 rows h1, h2, dy16, dh2pre16, dh1pre16 (the operands the
TPU kernel rounds before its weight-gradient products) into a workspace of
4 + (d_pad / H) [M, H] bf16 streams, and keeps the bias/γ/β column sums per
block; the weight-gradient pass (`fused_mlp_wgrad`) computes xᵢᵀ·dh1pre16,
h1ᵀ·dh2pre16 and h2ᵀ·dy16 per lane with a 128 × 128 float32 tile in
registers over a chunk of rows, and `lane_reduce` sums the partials in
order. The `torch.autograd.Function`s below put each forward kernel and
its backward together; `fused_mlp_ln_parts`, `fused_mlp_noln_parts` and
`fused_premlp_res_parts` call them on both devices.

Tolerance of a backward kernel vs its plain version: as for the forward, a
float32 sum in another order can move a bf16 rounding of dy, dh2pre or
dh1pre, and so dx, by a step: 2 bf16 ulps of dx's scale; the weight
gradients sum many rows in another order before their one rounding: 2
bf16 ulps of their scale.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

LN_EPS = 1e-6            # flax.linen.LayerNorm default epsilon
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715

# incremented once per kernel launch, and nowhere else
LAUNCHES_LN = 0
LAUNCHES_NOLN = 0
LAUNCHES_PREMLP = 0
LAUNCHES_LN_BWD = 0
LAUNCHES_NOLN_BWD = 0
LAUNCHES_PREMLP_BWD = 0


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (flax nn.gelu default), float32 in/out."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def _gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-approximate GELU, float32 (the JAX package's
    `_gelu_tanh_grad`, same operation order)."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 × bf16 product with float32 accumulation (the products of two
    bf16 values are exact in float32)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _chain_parts(parts, w1s, b1, w2, b2, w3, b3, pres, dt):
    """The forward chain with its intermediates: (h1pre, h1, h2pre, h2, y),
    all float32 (h1, h2 are rounded to dt where the next product takes
    them)."""
    f32 = torch.float32
    h1pre = b1.to(f32).reshape(-1)
    for p in pres:
        h1pre = h1pre + p.to(f32)
    for xp, w1p in zip(parts, w1s):
        h1pre = h1pre + _dot_f32(xp, w1p)
    h1 = _gelu_tanh(h1pre)
    h2pre = _dot_f32(h1.to(dt), w2) + b2.to(f32).reshape(-1)
    h2 = _gelu_tanh(h2pre)
    y = _dot_f32(h2.to(dt), w3) + b3.to(f32).reshape(-1)
    return h1pre, h1, h2pre, h2, y


def _chain(parts, w1s, b1, w2, b2, w3, b3, pres, dt):
    return _chain_parts(parts, w1s, b1, w2, b2, w3, b3, pres, dt)[-1]


def _ln_stats(y: torch.Tensor):
    """flax fast-variance LayerNorm statistics in float32: (mu, rstd)."""
    mu = y.mean(dim=-1, keepdim=True)
    var = torch.clamp((y * y).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + LN_EPS)


def _ln_bwd(g, xhat, rstd, gamma):
    """LayerNorm backward in float32: dy = rstd·(gx − mean(gx) −
    xhat·mean(gx·xhat)) with gx = g·γ."""
    gx = g * gamma.to(torch.float32).reshape(-1)
    m1 = gx.mean(dim=-1, keepdim=True)
    m2 = (gx * xhat).mean(dim=-1, keepdim=True)
    return rstd * (gx - m1 - xhat * m2)


def weight_grad(a: torch.Tensor, b: torch.Tensor, lanes: int,
                dtype) -> torch.Tensor:
    """aᵀ·b over the rows of a [M, k] and b [M, n], as the JAX package's
    kernels produce a weight gradient under the model's per-sample vmap:
    the float32 sum over each batch lane's M / lanes rows is rounded to
    `dtype`, then the lanes are summed in float32 and rounded once more
    (with one lane: a single rounding)."""
    m = a.shape[0]
    a3 = a.to(torch.float32).reshape(lanes, m // lanes, a.shape[-1])
    b3 = b.to(torch.float32).reshape(lanes, m // lanes, b.shape[-1])
    per = torch.bmm(a3.transpose(1, 2), b3)
    return per.to(dtype).to(torch.float32).sum(dim=0).to(dtype)


def _mlp_chain_bwd(parts, w1s, w2, w3, dt, h1pre, h1, h2pre, h2, dy, lanes):
    """Backward of the 2-hidden-layer chain from dy [M, d] (float32), with
    the JAX kernel's rounding points: dy, dh2pre and dh1pre rounded to dt
    before each product. Returns (dh1pre, dh2pre [f32], dxs [f32, without
    any residual], dw1s, dw2, dw3 [rounded to the weights' type])."""
    dy16 = dy.to(dt)
    dw3 = weight_grad(h2.to(dt), dy16, lanes, w3.dtype)
    dh2pre = _dot_f32(dy16, w3.t()) * _gelu_tanh_grad(h2pre)
    dh2pre16 = dh2pre.to(dt)
    dw2 = weight_grad(h1.to(dt), dh2pre16, lanes, w2.dtype)
    dh1pre = _dot_f32(dh2pre16, w2.t()) * _gelu_tanh_grad(h1pre)
    dh1pre16 = dh1pre.to(dt)
    dw1s = [weight_grad(xp, dh1pre16, lanes, w1p.dtype)
            for xp, w1p in zip(parts, w1s)]
    dxs = [_dot_f32(dh1pre16, w1p.t()) for w1p in w1s]
    return dh1pre, dh2pre, dxs, dw1s, dw2, dw3


class MlpLnGrads(NamedTuple):
    """Gradients of `fused_mlp_ln` (K3's outputs): dxs per part (stream
    type), dpres per pre (the pre's type), weight gradients rounded to the
    weights' type, bias/γ/β gradients float32 [H]."""
    dxs: Tuple[torch.Tensor, ...]
    dpres: Tuple[torch.Tensor, ...]
    dw1s: Tuple[torch.Tensor, ...]
    db1: torch.Tensor
    dw2: torch.Tensor
    db2: torch.Tensor
    dw3: torch.Tensor
    db3: torch.Tensor
    dgamma: torch.Tensor
    dbeta: torch.Tensor


def fused_mlp_ln_bwd_reference(parts, w1s, b1, w2, b2, w3, b3, gamma, pres,
                               douts, res_idx: Optional[int] = None,
                               res_dual: bool = False,
                               lanes: int = 1) -> MlpLnGrads:
    """Plain PyTorch version of K3 on the operands of `fused_mlp_ln` and the
    output cotangents `douts` (one, or two with res_dual), rounding where
    the JAX kernel `_make_bwd_kernel` rounds. The rows are `lanes` batch
    lanes of M / lanes rows each (see `weight_grad`)."""
    f32 = torch.float32
    dt = parts[0].dtype if parts else pres[0].dtype
    h1pre, h1, h2pre, h2, y = _chain_parts(parts, w1s, b1, w2, b2, w3, b3,
                                           pres, dt)
    mu, rstd = _ln_stats(y)
    xhat = (y - mu) * rstd
    # residual routing: the LayerNorm sees the sum of the raw and the
    # residual-sum cotangents; the residual part also takes the latter
    g = douts[0].to(f32)
    if res_idx is not None and res_dual:
        g = g + douts[1].to(f32)
    dgamma = (g * xhat).sum(dim=0)
    dbeta = g.sum(dim=0)
    dy = _ln_bwd(g, xhat, rstd, gamma)
    dh1pre, dh2pre, dxs, dw1s, dw2, dw3 = _mlp_chain_bwd(
        parts, w1s, w2, w3, dt, h1pre, h1, h2pre, h2, dy, lanes)
    if res_idx is not None:
        dres = douts[1] if res_dual else douts[0]
        dxs[res_idx] = dxs[res_idx] + dres.to(f32)
    return MlpLnGrads(
        dxs=tuple(d.to(p.dtype) for d, p in zip(dxs, parts)),
        dpres=tuple(dh1pre.to(p.dtype) for p in pres),
        dw1s=tuple(dw1s), db1=dh1pre.sum(dim=0), dw2=dw2,
        db2=dh2pre.sum(dim=0), dw3=dw3, db3=dy.sum(dim=0), dgamma=dgamma,
        dbeta=dbeta)


def fused_mlp_noln_bwd_reference(x, w1, b1, w2, b2, w3, b3, dout,
                                 lanes: int = 1):
    """Plain PyTorch version of K4b: (dx, dw1, db1, dw2, db2, dw3, db3) for
    the decoder chain and its [M, d] output cotangent (the JAX kernel pads
    d to 128 lanes with zeros: the same function)."""
    dt = x.dtype
    h1pre, h1, h2pre, h2, _ = _chain_parts([x], [w1], b1, w2, b2, w3, b3, (),
                                           dt)
    dy = dout.to(torch.float32)
    dh1pre, dh2pre, dxs, dw1s, dw2, dw3 = _mlp_chain_bwd(
        [x], [w1], w2, w3, dt, h1pre, h1, h2pre, h2, dy, lanes)
    return (dxs[0].to(dt), dw1s[0], dh1pre.sum(dim=0), dw2,
            dh2pre.sum(dim=0), dw3, dy.sum(dim=0))


def fused_mlp_ln_reference(parts: Sequence[torch.Tensor],
                           w1s: Sequence[torch.Tensor], b1, w2, b2, w3, b3,
                           gamma, beta, pres: Sequence[torch.Tensor] = (),
                           res_idx: Optional[int] = None,
                           res_dual: bool = False):
    """Plain PyTorch version of K2 on prepared operands: parts [M, kᵢ] and
    weights already in the stream type, biases/γ/β float32 [H] or [1, H]."""
    dt = parts[0].dtype if parts else pres[0].dtype
    y = _chain(parts, w1s, b1, w2, b2, w3, b3, pres, dt)
    mu = y.mean(dim=-1, keepdim=True)
    var = torch.clamp((y * y).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    out = (y - mu) * torch.rsqrt(var + LN_EPS) * gamma.to(torch.float32) \
        + beta.to(torch.float32)
    out16 = out.to(dt)
    if res_idx is None:
        return out16
    if res_dual:
        return out16, out16 + parts[res_idx]
    return out16 + parts[res_idx]


def fused_mlp_noln_reference(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain PyTorch version of K4f on prepared operands; returns [M, d] in
    the stream type."""
    y = _chain([x], [w1], b1, w2, b2, w3, b3, (), x.dtype)
    return y.to(x.dtype)


def _check(t: torch.Tensor, shape: Tuple[int, ...], dtype, name: str,
           device=None):
    """The operand `name` of a kernel, contiguous; raises unless it has this
    shape and type and lies on `device` (a CUDA device unless given)."""
    on = t.is_cuda if device is None else t.device == device
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not on:
        where = "CUDA" if device is None else str(device)
        raise ValueError(
            f"kernel operand {name} must be a {where} {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _vec(v, n: int, name: str, device=None):
    return _check(v.reshape(-1), (n,), torch.float32, name, device)


def part_width_ok(w: int) -> bool:
    """A part width the MLP kernels take: a multiple of 16 below 128 (the
    node MLP's 64-wide `nbr_avg`), a multiple of 128 from there on (the JAX
    package's rule, `k % 128 == 0 or k < 128`, at 16-element granularity)."""
    return w > 0 and (w % 128 == 0 or (w < 128 and w % 16 == 0))


def _mlp_operands(parts, w1s, b1, w2, b2, w3, b3, gamma, pres, res_idx,
                  layer_norm, what):
    """The shape/type checks shared by K2/K4f and K3/K4b, raising on what
    the kernels do not take: hidden width H a multiple of 128, the
    LayerNorm's width H, part widths by `part_width_ok`, the residual part
    H wide, a narrow head of at most 16 columns without LayerNorm. Every
    operand must lie on the first input's device. Returns (parts, pres,
    w1 [Σkᵢ, H] or None, w2, w3, b1, b2, b3, gamma or None, part widths,
    d_out, H), contiguous. Whether the shape fits a block's shared memory
    is the kernel library's to say (`gfvgn_fused_mlp_workspace`)."""
    bf16 = torch.bfloat16
    if len(parts) > 2 or len(pres) > 1 or not (parts or pres):
        raise NotImplementedError(
            f"{what} takes at most 2 parts and 1 pre-projected input, got "
            f"{len(parts)} and {len(pres)}")
    lead = parts[0] if parts else pres[0]
    m, dev = lead.shape[0], lead.device
    h = w2.shape[0]
    if w2.ndim != 2 or w2.shape[1] != h or h % 128 != 0 or h == 0:
        raise NotImplementedError(
            f"{what} takes a hidden width that is a multiple of 128, got w2 "
            f"{tuple(w2.shape)}")
    d_out = w3.shape[1]
    if layer_norm and d_out != h:
        raise NotImplementedError(f"{what} with LayerNorm needs its width "
                                  f"equal to the hidden width {h}, got "
                                  f"{d_out}")
    if not layer_norm and d_out > 16:
        raise NotImplementedError(f"{what} without LayerNorm needs out "
                                  f"width <= 16")
    widths = [p.shape[1] for p in parts]
    if not all(part_width_ok(w) for w in widths):
        raise NotImplementedError(
            f"{what} takes part widths that are multiples of 16 below 128 or "
            f"multiples of 128, got {widths}")
    if res_idx is not None and widths[res_idx] != h:
        raise NotImplementedError(f"the residual part must be {h} wide")
    parts = [_check(p, (m, w), bf16, f"part {i}", dev)
             for i, (p, w) in enumerate(zip(parts, widths))]
    pres = [_check(p, (m, h), bf16, "pre", dev) for p in pres]
    w1s = [_check(w1p, (w, h), bf16, "w1 slice", dev)
           for w1p, w in zip(w1s, widths)]
    w1 = (None if not w1s else w1s[0] if len(w1s) == 1
          else torch.cat(w1s, dim=0))
    return (parts, pres, w1, _check(w2, (h, h), bf16, "w2", dev),
            _check(w3, (h, d_out), bf16, "w3", dev), _vec(b1, h, "b1", dev),
            _vec(b2, h, "b2", dev), _vec(b3, d_out, "b3", dev),
            _vec(gamma, h, "gamma", dev) if layer_norm else None, widths,
            d_out, h)


def _workspace(lib, widths, h, has_pre, layer_norm, d_out, m, lanes,
               backward, dev, what):
    """The kernels' workspace (uint8 on `dev`); raises where the library
    takes no kernel for the shape (it does not fit a block's shared
    memory)."""
    n = lib.gfvgn_fused_mlp_workspace(
        widths[0] if widths else 0, widths[1] if len(widths) > 1 else 0, h,
        int(has_pre), int(layer_norm), d_out, m, lanes, int(backward))
    if n < 0:
        raise NotImplementedError(
            f"{what}: no kernel takes parts {widths} at hidden width {h} "
            f"(the tile does not fit a block's shared memory)")
    return torch.empty((max(n, 1),), dtype=torch.uint8, device=dev)


def _cuda_lead(lead, what):
    if not lead.is_cuda:
        raise ValueError(f"{what} launches on CUDA tensors only, got "
                         f"{lead.device}")
    return lead.device


def _launch(parts, w1s, b1, w2, b2, w3, b3, gamma, beta, pres, res_idx,
            res_dual, layer_norm):
    """Checks, output allocation and the one launch shared by K2 and
    K4f."""
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    what = "fused MLP kernel"
    dev = _cuda_lead(parts[0] if parts else pres[0], what)
    parts, pres, w1, w2, w3, b1, b2, b3, gamma, widths, d_out, h = \
        _mlp_operands(parts, w1s, b1, w2, b2, w3, b3, gamma, pres, res_idx,
                      layer_norm, what)
    if layer_norm:
        beta = _vec(beta, h, "beta", dev)
    m = (parts[0] if parts else pres[0]).shape[0]
    lib = load_library()
    n_out = 2 if (res_idx is not None and res_dual) else 1
    ws = _workspace(lib, widths, h, bool(pres), layer_norm, d_out, m, 1,
                    False, dev, what)
    outs = [torch.empty((m, d_out), dtype=torch.bfloat16, device=dev)
            for _ in range(n_out)]
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.gfvgn_fused_mlp(
            ptr(parts[0] if parts else None),
            ptr(parts[1] if len(parts) > 1 else None),
            widths[0] if parts else 0, widths[1] if len(parts) > 1 else 0, h,
            ptr(w1), ptr(pres[0] if pres else None),
            ptr(b1), ptr(w2), ptr(b2), ptr(w3), ptr(b3),
            ptr(gamma), ptr(beta if layer_norm else None),
            ptr(outs[0]), ptr(outs[1] if n_out == 2 else None),
            m, -1 if res_idx is None else int(res_idx), int(bool(res_dual)),
            int(layer_norm), d_out, ws.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused MLP kernel launch failed: CUDA error {err}")
    return outs


def _launch_bwd(parts, w1s, b1, w2, b2, w3, b3, gamma, pres, douts, res_idx,
                res_dual, lanes, layer_norm):
    """Checks, allocation and the launches of K3 / K4b (the row pass, the
    weight-gradient pass and the fixed-order reductions): returns (dxs, dpre
    or None, the float32 gradient slab, Σkᵢ, H, the slab's padded out
    width)."""
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    bf16, f32 = torch.bfloat16, torch.float32
    what = "fused MLP backward kernel"
    dev = _cuda_lead(parts[0] if parts else pres[0], what)
    parts, pres, w1, w2, w3, b1, b2, b3, gamma, widths, d_out, h = \
        _mlp_operands(parts, w1s, b1, w2, b2, w3, b3, gamma, pres, res_idx,
                      layer_norm, what)
    m = (parts[0] if parts else pres[0]).shape[0]
    if lanes < 1 or m % lanes:
        raise ValueError(f"{m} rows do not split into {lanes} equal lanes")
    n_dout = 2 if (res_idx is not None and res_dual) else 1
    if len(douts) != n_dout:
        raise ValueError(f"expected {n_dout} output cotangents")
    douts = [_check(g, (m, d_out if i == 0 else h), bf16, "dout", dev)
             for i, g in enumerate(douts)]
    lib = load_library()
    # the workspace holds the rows the weight-gradient pass reads (h1, h2,
    # dy16, dh2pre16, dh1pre16: 4 + d_pad/H streams of [M, H] bf16) and the
    # float32 partials; it is freed when the call returns
    ws = _workspace(lib, widths, h, bool(pres), layer_norm, d_out, m, lanes,
                    True, dev, what)
    dxs = [torch.empty((m, w), dtype=bf16, device=dev) for w in widths]
    dpre = torch.empty((m, h), dtype=bf16, device=dev) if pres else None
    k1 = sum(widths)
    d_pad = h if layer_norm else 16
    total = torch.empty((k1 * h + h * h + h * d_pad + 4 * h + d_pad,),
                        dtype=f32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.gfvgn_fused_mlp_bwd(
            ptr(parts[0] if parts else None),
            ptr(parts[1] if len(parts) > 1 else None),
            widths[0] if parts else 0, widths[1] if len(parts) > 1 else 0, h,
            ptr(w1), ptr(pres[0] if pres else None),
            ptr(b1), ptr(w2), ptr(b2), ptr(w3), ptr(b3), ptr(gamma),
            ptr(douts[0]), ptr(douts[1] if n_dout == 2 else None),
            ptr(dxs[0] if dxs else None),
            ptr(dxs[1] if len(dxs) > 1 else None), ptr(dpre), ptr(total),
            m, -1 if res_idx is None else int(res_idx), int(bool(res_dual)),
            int(layer_norm), d_out, lanes, ws.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused MLP backward kernel launch failed: CUDA error {err}")
    return dxs, dpre, total, k1, h, d_pad


def _split_slab(total, k1, h, d_out, d_pad, widths):
    """The summed slab [dW1 | dW2 | dW3 | db1 | db2 | db3 | dγ | dβ] as
    float32 tensors (dW1 split by part rows)."""
    o = 0

    def take(n):
        nonlocal o
        t = total[o:o + n]
        o += n
        return t
    dw1 = take(k1 * h).reshape(k1, h)
    dw2 = take(h * h).reshape(h, h)
    dw3 = take(h * d_pad).reshape(h, d_pad)[:, :d_out]
    db1, db2 = take(h), take(h)
    db3 = take(d_pad)[:d_out]
    dgamma, dbeta = take(h), take(h)
    offs = [0]
    for w in widths:
        offs.append(offs[-1] + w)
    dw1s = [dw1[offs[i]:offs[i + 1]] for i in range(len(widths))]
    return dw1s, dw2, dw3, db1, db2, db3, dgamma, dbeta


def fused_mlp_ln_bwd(parts, w1s, b1, w2, b2, w3, b3, gamma, pres, douts,
                     res_idx: Optional[int] = None,
                     res_dual: bool = False, lanes: int = 1) -> MlpLnGrads:
    """K3 on the operands of `fused_mlp_ln` and its output cotangents.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_mlp_ln_bwd_reference`."""
    global LAUNCHES_LN_BWD
    lead = parts[0] if parts else pres[0]
    if lead.device.type != "cuda":
        return fused_mlp_ln_bwd_reference(parts, w1s, b1, w2, b2, w3, b3,
                                          gamma, pres, douts, res_idx,
                                          res_dual, lanes)
    if res_idx is not None and not 0 <= res_idx < len(parts):
        raise ValueError(f"res_idx {res_idx} names no part")
    dxs, dpre, total, k1, h, d_pad = _launch_bwd(
        list(parts), list(w1s), b1, w2, b2, w3, b3, gamma, list(pres),
        list(douts), res_idx, res_dual, lanes, layer_norm=True)
    LAUNCHES_LN_BWD += 1
    dw1s, dw2, dw3, db1, db2, db3, dgamma, dbeta = _split_slab(
        total, k1, h, h, d_pad, [p.shape[1] for p in parts])
    bf16 = torch.bfloat16
    return MlpLnGrads(
        dxs=tuple(dxs), dpres=(dpre,) if pres else (),
        dw1s=tuple(d.to(bf16) for d in dw1s), db1=db1, dw2=dw2.to(bf16),
        db2=db2, dw3=dw3.to(bf16), db3=db3, dgamma=dgamma, dbeta=dbeta)


def fused_mlp_noln_bwd(x, w1, b1, w2, b2, w3, b3, dout, lanes: int = 1):
    """K4b: (dx, dw1, db1, dw2, db2, dw3, db3) for the decoder chain, x
    [M, K] bf16 and dout [M, d] bf16 with d <= 16.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_mlp_noln_bwd_reference`."""
    global LAUNCHES_NOLN_BWD
    if x.device.type != "cuda":
        return fused_mlp_noln_bwd_reference(x, w1, b1, w2, b2, w3, b3, dout,
                                            lanes)
    d_out = w3.shape[1]
    dxs, _, total, k1, h, d_pad = _launch_bwd(
        [x], [w1], b1, w2, b2, w3, b3, None, [], [dout], None, False,
        lanes, layer_norm=False)
    LAUNCHES_NOLN_BWD += 1
    dw1s, dw2, dw3, db1, db2, db3, _, _ = _split_slab(
        total, k1, h, d_out, d_pad, [x.shape[1]])
    bf16 = torch.bfloat16
    return (dxs[0], dw1s[0].to(bf16), db1, dw2.to(bf16), db2,
            dw3.to(bf16), db3)


def fused_mlp_ln(parts, w1s, b1, w2, b2, w3, b3, gamma, beta, pres=(),
                 res_idx: Optional[int] = None, res_dual: bool = False):
    """K2 on prepared operands. parts: up to two [M, kᵢ] bf16 (kᵢ by
    `part_width_ok`; the residual part H wide); w1s: [kᵢ, H] bf16 each;
    w2, w3 [H, H] bf16 (H a multiple of 128); biases/γ/β float32; pres:
    already-projected [M, H] bf16. Returns LN(MLP(...)) [M, H]; with
    res_dual also the residual sum.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_mlp_ln_reference`."""
    global LAUNCHES_LN
    lead = parts[0] if parts else pres[0]
    if lead.device.type != "cuda":
        return fused_mlp_ln_reference(parts, w1s, b1, w2, b2, w3, b3, gamma,
                                      beta, pres, res_idx, res_dual)
    if res_idx is not None and not 0 <= res_idx < len(parts):
        raise ValueError(f"res_idx {res_idx} names no part")
    outs = _launch(list(parts), list(w1s), b1, w2, b2, w3, b3, gamma, beta,
                   list(pres), res_idx, res_dual, layer_norm=True)
    LAUNCHES_LN += 1
    return tuple(outs) if len(outs) == 2 else outs[0]


def fused_mlp_noln(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """K4f on prepared operands: x [M, K] bf16 (K by `part_width_ok`),
    w2 [H, H], w3 [H, d] with d <= 16. Returns [M, d] bf16."""
    global LAUNCHES_NOLN
    if x.device.type != "cuda":
        return fused_mlp_noln_reference(x, w1, b1, w2, b2, w3, b3)
    outs = _launch([x], [w1], b1, w2, b2, w3, b3, None, None, [], None,
                   False, layer_norm=False)
    LAUNCHES_NOLN += 1
    return outs[0]


def fused_mlp_ln_parts(parts: Sequence[torch.Tensor], w1, b1, w2, b2, w3, b3,
                       gamma, beta, dtype=torch.bfloat16,
                       pres: Sequence[torch.Tensor] = (),
                       w1_rows: Optional[Sequence[Tuple[int, int]]] = None,
                       res_idx: Optional[int] = None,
                       res_dual: bool = False, lanes: int = 1):
    """Dispatch wrapper for the model code (counterpart of the JAX function
    of the same name), differentiable: K2 forward, K3 backward.

    `w1` is the FULL first-layer kernel [(Σkᵢ), H] of the parameter tree; it
    is row-sliced per part here — by cumulative part widths, or by explicit
    `w1_rows` (o0, o1) spans when some rows of w1 were consumed by external
    projections (`pres`, already [M, H] in the first hidden basis). pres
    keep their incoming type. A part whose width is neither a multiple of
    128 nor below 128 is zero-padded, with its W1 rows, to the next
    multiple of 128, as the JAX wrapper pads it (on both devices). The row
    count M need not be a multiple of anything: the kernel masks its
    ragged tile. The M rows are `lanes`
    batch lanes of equal size (the backward rounds the weight gradients
    per lane, see `weight_grad`)."""
    widths = [p.shape[1] for p in parts]
    if w1_rows is None:
        offs = [0]
        for w in widths:
            offs.append(offs[-1] + w)
        w1_rows = [(offs[i], offs[i + 1]) for i in range(len(parts))]
    if not parts and not pres:
        raise ValueError("fused_mlp_ln_parts needs at least one input")
    if not parts and res_idx is not None:
        raise ValueError("the pres-only form has no part to add as residual")
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    parts16, w1s = [], []
    for p, (o0, o1) in zip(parts, w1_rows):
        p16, w1p = p.to(dtype), w1[o0:o1].to(dtype)
        k = p.shape[1]
        if not (k % 128 == 0 or k < 128):
            # as the JAX wrapper does: a part of another width is zero-padded,
            # with its W1 rows, to the next multiple of 128 (the segment
            # node MLP's one 192-wide part); inside autograd, so dx and dW1
            # come back k wide
            k_pad = -(-k // 128) * 128
            p16 = F.pad(p16, (0, k_pad - k))
            w1p = F.pad(w1p, (0, 0, 0, k_pad - k))
        parts16.append(p16)
        w1s.append(w1p)
    meta = (len(parts16), len(pres), res_idx, bool(res_dual),
            plain_versions_active(), lanes)
    outs = _MlpLnFn.apply(meta, *parts16, *w1s, *pres, b1, w2.to(dtype), b2,
                          w3.to(dtype), b3, gamma, beta)
    return outs


class _MlpLnFn(torch.autograd.Function):
    """K2 forward, K3 backward (or their plain versions when `plain` was
    set at the forward). Saves only the forward's inputs: the backward
    recomputes the chain."""

    @staticmethod
    def forward(ctx, meta, *ts):
        n_parts, n_pre, res_idx, res_dual, plain, _ = meta
        parts, w1s = ts[:n_parts], ts[n_parts:2 * n_parts]
        pres = ts[2 * n_parts:2 * n_parts + n_pre]
        b1, w2, b2, w3, b3, gamma, beta = ts[2 * n_parts + n_pre:]
        fn = fused_mlp_ln_reference if plain else fused_mlp_ln
        out = fn(list(parts), list(w1s), b1, w2, b2, w3, b3, gamma, beta,
                 tuple(pres), res_idx=res_idx, res_dual=res_dual)
        ctx.meta = meta
        ctx.save_for_backward(*ts)
        return out

    @staticmethod
    def backward(ctx, *gs):
        n_parts, n_pre, res_idx, res_dual, plain, lanes = ctx.meta
        ts = ctx.saved_tensors
        parts, w1s = ts[:n_parts], ts[n_parts:2 * n_parts]
        pres = ts[2 * n_parts:2 * n_parts + n_pre]
        b1, w2, b2, w3, b3, gamma, beta = ts[2 * n_parts + n_pre:]
        fn = fused_mlp_ln_bwd_reference if plain else fused_mlp_ln_bwd
        gr = fn(list(parts), list(w1s), b1, w2, b2, w3, b3, gamma,
                list(pres), [g.contiguous() for g in gs], res_idx, res_dual,
                lanes)
        return (None, *gr.dxs, *gr.dw1s, *gr.dpres,
                gr.db1.reshape(b1.shape), gr.dw2, gr.db2.reshape(b2.shape),
                gr.dw3, gr.db3.reshape(b3.shape),
                gr.dgamma.reshape(gamma.shape), gr.dbeta.reshape(beta.shape))


class _MlpNolnFn(torch.autograd.Function):
    """K4f forward, K4b backward (or their plain versions)."""

    @staticmethod
    def forward(ctx, meta, x, w1, b1, w2, b2, w3, b3):
        plain, _ = meta
        fn = fused_mlp_noln_reference if plain else fused_mlp_noln
        ctx.meta = meta
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        return fn(x, w1, b1, w2, b2, w3, b3)

    @staticmethod
    def backward(ctx, g):
        plain, lanes = ctx.meta
        x, w1, b1, w2, b2, w3, b3 = ctx.saved_tensors
        fn = fused_mlp_noln_bwd_reference if plain else fused_mlp_noln_bwd
        dx, dw1, db1, dw2, db2, dw3, db3 = fn(x, w1, b1, w2, b2, w3, b3,
                                              g.contiguous(), lanes)
        return (None, dx, dw1, db1.reshape(b1.shape), dw2,
                db2.reshape(b2.shape), dw3, db3.reshape(b3.shape))


def fused_mlp_noln_parts(x, w1, b1, w2, b2, w3, b3,
                         dtype=torch.bfloat16, lanes: int = 1) -> torch.Tensor:
    """Dispatch wrapper for the Decoder: casts the stream and the weights;
    the narrow head is written as it is (no 128-lane padding). The rows of
    x [M, K] are `lanes` batch lanes (the backward's weight gradients are
    rounded per lane, see `weight_grad`)."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    return _MlpNolnFn.apply((plain_versions_active(), lanes), x.to(dtype),
                            w1.to(dtype), b1, w2.to(dtype), b2,
                            w3.to(dtype), b3)


def fused_premlp_res_reference(x, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of K5f on prepared operands: x [M, C] and
    w1 [C, Hd], w2 [Hd, C] in the stream type; γ, β, b1, b2 float32."""
    f32, dt = torch.float32, x.dtype
    x32 = x.to(f32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    xhat = (x32 - mu) * torch.rsqrt(var + LN_EPS)
    u16 = (xhat * gamma.to(f32) + beta.to(f32)).to(dt)
    h = _gelu_tanh(_dot_f32(u16, w1) + b1.to(f32))
    # the residual joins in float32, before the one rounding of the output
    y = _dot_f32(h.to(dt), w2) + b2.to(f32) + x32
    return y.to(dt)


# what a block of the H100 can hold (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_PER_BLOCK = 232_448


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def _ring_bytes(tm: int) -> int:
    """Two ring slots of streamed weight chunks (mma_sm90.cuh `ring_slot`)
    for a tile of tm rows: 32 contraction rows by the pass width, or the
    transposed chunk, whichever is larger."""
    pw = (8 // (tm // 16)) * 64
    return 2 * max(32 * (pw + 8), pw * 40) * 2


# K5f's strip kernel at C = 128 (csrc/fused_premlp.cu `premlp_rows`): its
# warps, and its shared memory: W1 [128][264] and W2 [256][136] bf16, the
# vectors γ | β | b1 | b2 float32, two [16][136] bf16 x buffers a warp
PREMLP_ROWS_WARPS = 8
PREMLP_ROWS_SMEM = (128 * 264 * 2 + 256 * 136 * 2 + (3 * 128 + 256) * 4
                    + PREMLP_ROWS_WARPS * 2 * 16 * 136 * 2)


# K5f/K5b's passes from C = 256 on (csrc/fused_premlp.cu `premlp_pass`): a
# block's 64-row tile of 128 output columns, two ring slots each holding a
# 32-column chunk of A ([64][40] bf16) and of the weight (the ring slot of
# a 128-wide pass), and the row warps' column sums [4][128] float32
PREMLP_PASS_TM = 64
PREMLP_PASS_SMEM = 2 * (64 * 40 * 2 + _ring_bytes(64) // 2) + 4 * 128 * 4


def premlp_plan(c: int, backward: bool):
    """How K5f (backward False) or K5b runs width c with hidden width 2c,
    as csrc/fused_premlp.cu decides it (`premlp_form`): at c = 128 the
    forward on the strip kernel, ("rows", warps, shared-memory bytes), and
    the backward on the block row tiles `tile_plan` chooses, ("tiles", tm,
    weights resident, row buffers, shared-memory bytes); every wider c as
    passes through device memory, ("passes", tile rows, shared-memory
    bytes), whose shared memory does not grow with c; None where c is not
    a multiple of 128."""
    if c < 128 or c % 128:
        return None
    if c > 128:
        return (("passes", PREMLP_PASS_TM, PREMLP_PASS_SMEM)
                if PREMLP_PASS_SMEM <= SMEM_PER_BLOCK else None)
    if not backward:
        return (("rows", PREMLP_ROWS_WARPS, PREMLP_ROWS_SMEM)
                if PREMLP_ROWS_SMEM <= SMEM_PER_BLOCK else None)
    hd = 2 * c
    for resident in (True, False):
        for tm in (64, 32, 16):
            for nbuf in (2, 1):
                wr = tm // 16
                size = _align128((c * (hd + 8) + hd * (c + 8)) * 2
                                 if resident else _ring_bytes(tm))
                size += 2 * _align128(nbuf * tm * (c + 8) * 2)
                size += _align128(tm * (c + 8) * 2)
                size += _align128(tm * (hd + 8) * 2)
                size += (_align128(tm * (c + 4) * 4) + _align128(tm * 2 * 4)
                         + _align128(wr * hd * 4) + _align128(hd * 4))
                size = max(size, 8 * 3 * c * 4)
                if size <= SMEM_PER_BLOCK:
                    return "tiles", tm, resident, nbuf, size
    return None


def premlp_shape_ok(c: int, hd: int) -> bool:
    """Whether K5f and K5b take the pre-LN MLP branch at width c and hidden
    width hd: hd = 2c (mlp_ratio 2) and c a multiple of 128, the JAX
    package's condition at mlp_ratio 2 (`c % 128 == 0 and hd % 128 == 0`;
    the kernels' size query, `gfvgn_premlp_workspace`, decides the same on
    the card)."""
    return hd == 2 * c and premlp_plan(c, True) is not None \
        and premlp_plan(c, False) is not None


def _premlp_operands(x, gamma, beta, w1, b1, w2, b2, what):
    """The checks shared by K5f and K5b, raising on what the kernels do not
    take: x [M, C] bf16, w1 [C, 2C] and w2 [2C, C] bf16, γ, β, b1, b2
    float32, C by `premlp_shape_ok`; returned contiguous."""
    bf16 = torch.bfloat16
    c = x.shape[-1]
    hd = w1.shape[-1]
    if x.ndim != 2 or tuple(w1.shape) != (c, hd) \
            or not premlp_shape_ok(c, hd):
        raise NotImplementedError(
            f"{what} takes x [M, C] with C a multiple of 128 and a hidden "
            f"width 2C, got x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    return (_check(x, tuple(x.shape), bf16, "x"), _vec(gamma, c, "gamma"),
            _vec(beta, c, "beta"), _check(w1, (c, hd), bf16, "w1"),
            _vec(b1, hd, "b1"), _check(w2, (hd, c), bf16, "w2"),
            _vec(b2, c, "b2"))


def fused_premlp_res(x, gamma, beta, w1, b1, w2, b2) -> torch.Tensor:
    """K5f on prepared operands: x [M, C] bf16, w1 [C, 2C] and w2 [2C, C]
    bf16, γ, β, b1, b2 float32 (C by `premlp_shape_ok`). Returns [M, C]
    bf16.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_premlp_res_reference`."""
    global LAUNCHES_PREMLP
    if x.device.type != "cuda":
        return fused_premlp_res_reference(x, gamma, beta, w1, b1, w2, b2)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    x, gamma, beta, w1, b1, w2, b2 = _premlp_operands(
        x, gamma, beta, w1, b1, w2, b2, "fused_premlp_res kernel")
    m, c = x.shape
    lib = load_library()
    out = torch.empty((m, c), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        # the passes from C = 256 on keep u16 and h16 in a workspace
        n = lib.gfvgn_premlp_workspace(c, m, 1, 0)
        if n < 0:
            raise NotImplementedError(
                f"fused_premlp_res kernel: no kernel takes C = {c}")
        ws = torch.empty((max(n, 1),), dtype=torch.uint8, device=x.device)
        err = lib.gfvgn_fused_premlp(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), c, m,
            ws.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_premlp_res kernel launch failed: CUDA error {err}")
    LAUNCHES_PREMLP += 1
    return out


def fused_premlp_res_bwd_reference(x, gamma, beta, w1, b1, w2, b2, dout,
                                   lanes: int = 1):
    """Plain PyTorch version of K5b: (dx, dgamma, dbeta, dw1, db1, dw2, db2)
    for the operands of `fused_premlp_res` and its output cotangent,
    rounding where the JAX kernel `_premlp_bwd_kernel` rounds: g, dh1pre
    rounded to the stream type before their products, the LayerNorm
    backward in float32, and the residual cotangent g joining dx in float32
    before the one rounding. The rows are `lanes` batch lanes (see
    `weight_grad`)."""
    f32, dt = torch.float32, x.dtype
    x32 = x.to(f32)
    mu, rstd = _ln_stats(x32)
    xhat = (x32 - mu) * rstd
    u16 = (xhat * gamma.to(f32).reshape(-1) + beta.to(f32).reshape(-1)).to(dt)
    h1pre = _dot_f32(u16, w1) + b1.to(f32).reshape(-1)
    h16 = _gelu_tanh(h1pre).to(dt)
    g = dout.to(f32)
    g16 = g.to(dt)
    dw2 = weight_grad(h16, g16, lanes, w2.dtype)
    dh1pre = _dot_f32(g16, w2.t()) * _gelu_tanh_grad(h1pre)
    dh1pre16 = dh1pre.to(dt)
    dw1 = weight_grad(u16, dh1pre16, lanes, w1.dtype)
    du = _dot_f32(dh1pre16, w1.t())
    dgamma = (du * xhat).sum(dim=0)
    dbeta = du.sum(dim=0)
    dx = _ln_bwd(du, xhat, rstd, gamma) + g
    return (dx.to(dt), dgamma, dbeta, dw1, dh1pre.sum(dim=0), dw2,
            g.sum(dim=0))


def fused_premlp_res_bwd(x, gamma, beta, w1, b1, w2, b2, dout,
                         lanes: int = 1):
    """K5b on the operands of `fused_premlp_res` and dout [M, C] bf16,
    the rows `lanes` batch lanes: (dx, dgamma, dbeta, dw1, db1, dw2,
    db2). At C = 128 three launches: the row pass, the weight-gradient
    pass and the fixed-order reductions, over a workspace of bf16 rows
    (u16, h16, dh1pre16: 5 [M, C] streams) and float32 partials freed on
    return; wider C runs the row pass as five passes (`premlp_plan`), with
    du [M, C] float32 and the rows' statistics in the workspace too.

    CUDA operands launch the kernel (or raise); CPU operands take
    `fused_premlp_res_bwd_reference`."""
    global LAUNCHES_PREMLP_BWD
    if x.device.type != "cuda":
        return fused_premlp_res_bwd_reference(x, gamma, beta, w1, b1, w2, b2,
                                              dout, lanes)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    bf16, f32 = torch.bfloat16, torch.float32
    what = "fused_premlp_res backward kernel"
    x, gamma, beta, w1, b1, w2, b2 = _premlp_operands(
        x, gamma, beta, w1, b1, w2, b2, what)
    m, c = x.shape
    hd = 2 * c
    if lanes < 1 or m % lanes:
        raise ValueError(f"{m} rows do not split into {lanes} equal lanes")
    dout = _check(dout, (m, c), bf16, "dout")
    lib = load_library()
    dev = x.device
    with torch.cuda.device(dev):
        n = lib.gfvgn_premlp_workspace(c, m, lanes, 1)
        if n < 0:
            raise NotImplementedError(f"{what}: no kernel takes C = {c}")
        ws = torch.empty((max(n, 1),), dtype=torch.uint8, device=dev)
        dx = torch.empty((m, c), dtype=bf16, device=dev)
        total = torch.empty((2 * c * hd + 5 * c,), dtype=f32, device=dev)
        err = lib.gfvgn_fused_premlp_bwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), dout.data_ptr(),
            dx.data_ptr(), total.data_ptr(), c, m, lanes, ws.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    LAUNCHES_PREMLP_BWD += 1
    # slab: [dW1 (C×2C) | dW2 (2C×C) | db1 (2C) | db2 | dγ | dβ (C each)]
    dw1 = total[:c * hd].reshape(c, hd).to(bf16)
    dw2 = total[c * hd:2 * c * hd].reshape(hd, c).to(bf16)
    o = 2 * c * hd
    db1 = total[o:o + hd]
    db2, dgamma, dbeta = (total[o + hd + i * c:o + hd + (i + 1) * c]
                          for i in range(3))
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


class _PremlpFn(torch.autograd.Function):
    """K5f forward, K5b backward (or their plain versions)."""

    @staticmethod
    def forward(ctx, meta, x, gamma, beta, w1, b1, w2, b2):
        plain, _ = meta
        fn = fused_premlp_res_reference if plain else fused_premlp_res
        ctx.meta = meta
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        return fn(x, gamma, beta, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        plain, lanes = ctx.meta
        x, gamma, beta, w1, b1, w2, b2 = ctx.saved_tensors
        fn = fused_premlp_res_bwd_reference if plain else fused_premlp_res_bwd
        dx, dgamma, dbeta, dw1, db1, dw2, db2 = fn(
            x, gamma, beta, w1, b1, w2, b2, g.contiguous(), lanes)
        return (None, dx, dgamma.reshape(gamma.shape),
                dbeta.reshape(beta.shape), dw1, db1.reshape(b1.shape), dw2,
                db2.reshape(b2.shape))


def fused_premlp_res_parts(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """Dispatch wrapper for the Transolver block (counterpart of the JAX
    function of the same name): casts the stream and the weights and runs
    K5f (K5b in the backward) over the rows of x [..., C]. The kernels mask
    their ragged tile, so no row padding is needed."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    lead = x.shape[:-1]
    lanes = x.shape[0] if x.ndim == 3 else 1
    out = _PremlpFn.apply((plain_versions_active(), lanes),
                          x.reshape(-1, x.shape[-1]).to(dtype), ln_scale,
                          ln_bias, w1.to(dtype), b1, w2.to(dtype), b2)
    return out.reshape(lead + (out.shape[-1],))
