"""Kernels K2 and K4f: the fused 2-hidden-layer GELU MLP chains, forward.

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

Both are one CUDA kernel template (csrc/fused_mlp.cu): a block stages W1
(up to 256×128), W2 and W3 in shared memory as bf16 once, then walks over
64-row tiles; the three products run on the tensor cores (wmma, bf16 in,
float32 accumulate) in the kernel's own body, and h1, h2, y never leave the
SM.

What bounds them here: bytes. A row costs ~131 k FLOP against ~1 KB moved,
under the card's ~295 FLOP/byte ridge. This first form is far from
that bound — it stages every accumulator through shared memory for the
elementwise steps — and its times stand in PERF.md.

Rounding points, identical in the kernel and in the plain versions below:
float32 accumulation in each product; h1 and h2 rounded to bf16 before the
next product; biases, pres, GELU (tanh form) and LayerNorm statistics (fast
variance clamped at 0, eps 1e-6) in float32; `out` rounded to bf16 BEFORE
the residual add, which is a bf16 add.

Tolerance kernel vs plain version: the float32 sums are taken in another
order (tensor-core fragments vs a library GEMM) and tanhf/sqrtf differ in
the last bit from PyTorch's, which can move a bf16 rounding of h1, h2 or
the output by one step: 2 bf16 ulps of the output scale.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

LN_EPS = 1e-6            # flax.linen.LayerNorm default epsilon
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715

# incremented once per kernel launch, and nowhere else
LAUNCHES_LN = 0
LAUNCHES_NOLN = 0


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (flax nn.gelu default), float32 in/out."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 × bf16 product with float32 accumulation (the products of two
    bf16 values are exact in float32)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _chain(parts, w1s, b1, w2, b2, w3, b3, pres, dt):
    f32 = torch.float32
    h1pre = b1.to(f32)
    for p in pres:
        h1pre = h1pre + p.to(f32)
    for xp, w1p in zip(parts, w1s):
        h1pre = h1pre + _dot_f32(xp, w1p)
    h1 = _gelu_tanh(h1pre)
    h2pre = _dot_f32(h1.to(dt), w2) + b2.to(f32)
    h2 = _gelu_tanh(h2pre)
    return _dot_f32(h2.to(dt), w3) + b3.to(f32)


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


def _check(t: torch.Tensor, shape: Tuple[int, ...], dtype, name: str):
    if tuple(t.shape) != shape or t.dtype != dtype or not t.is_cuda:
        raise ValueError(
            f"fused MLP kernel: {name} must be a CUDA {dtype} tensor of shape "
            f"{shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _launch(parts, w1s, b1, w2, b2, w3, b3, gamma, beta, pres, res_idx,
            res_dual, layer_norm):
    """Shape/type checks, output allocation and the one launch shared by the
    two kernels."""
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    bf16, f32 = torch.bfloat16, torch.float32
    if len(parts) > 2 or len(pres) > 1 or not (parts or pres):
        raise NotImplementedError(
            f"fused MLP kernel takes at most 2 parts and 1 pre-projected "
            f"input, got {len(parts)} and {len(pres)}")
    lead = parts[0] if parts else pres[0]
    m, dev = lead.shape[0], lead.device
    h = 128
    if tuple(w2.shape) != (h, h):
        raise NotImplementedError(
            f"fused MLP kernel is built for hidden width 128, got "
            f"{tuple(w2.shape)}")
    d_out = w3.shape[1]
    if layer_norm and d_out != h:
        raise NotImplementedError("fused_mlp_ln kernel needs out width 128")
    if not layer_norm and d_out > 16:
        raise NotImplementedError("fused_mlp_noln kernel needs out width <= 16")
    widths = [p.shape[1] for p in parts]
    if any(w % 16 != 0 or not 0 < w <= h for w in widths):
        raise NotImplementedError(
            f"fused MLP kernel takes part widths that are multiples of 16 up "
            f"to 128, got {widths}")
    if res_idx is not None and widths[res_idx] != h:
        raise NotImplementedError("the residual part must be 128 wide")
    parts = [_check(p, (m, w), bf16, f"part {i}")
             for i, (p, w) in enumerate(zip(parts, widths))]
    pres = [_check(p, (m, h), bf16, "pre") for p in pres]
    w1 = (torch.cat([_check(w1p, (w, h), bf16, "w1 slice")
                     for w1p, w in zip(w1s, widths)], dim=0)
          if parts else None)
    w2 = _check(w2, (h, h), bf16, "w2")
    w3 = _check(w3, (h, d_out), bf16, "w3")
    vec = lambda v, n, name: _check(v.reshape(-1), (n,), f32, name)
    b1, b2, b3 = vec(b1, h, "b1"), vec(b2, h, "b2"), vec(b3, d_out, "b3")
    if layer_norm:
        gamma, beta = vec(gamma, h, "gamma"), vec(beta, h, "beta")
    n_out = 2 if (res_idx is not None and res_dual) else 1
    outs = [torch.empty((m, d_out), dtype=bf16, device=dev)
            for _ in range(n_out)]
    ptr = lambda t: 0 if t is None else t.data_ptr()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    err = load_library().gfvgn_fused_mlp(
        ptr(parts[0] if parts else None),
        ptr(parts[1] if len(parts) > 1 else None),
        widths[0] if parts else 0, widths[1] if len(parts) > 1 else 0,
        ptr(w1), ptr(pres[0] if pres else None),
        ptr(b1), ptr(w2), ptr(b2), ptr(w3), ptr(b3),
        ptr(gamma if layer_norm else None), ptr(beta if layer_norm else None),
        ptr(outs[0]), ptr(outs[1] if n_out == 2 else None),
        m, -1 if res_idx is None else int(res_idx), int(bool(res_dual)),
        int(layer_norm), d_out, n_sm,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused MLP kernel launch failed: CUDA error {err}")
    return outs


def fused_mlp_ln(parts, w1s, b1, w2, b2, w3, b3, gamma, beta, pres=(),
                 res_idx: Optional[int] = None, res_dual: bool = False):
    """K2 on prepared operands. parts: up to two [M, kᵢ] bf16 (kᵢ a multiple
    of 16 up to 128; the residual part 128 wide); w1s: [kᵢ, 128] bf16 each; biases/γ/β float32; pres: already-projected [M, 128] bf16.
    Returns LN(MLP(...)) [M, 128]; with res_dual also the residual sum.

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
    """K4f on prepared operands: x [M, 128] bf16, w3 [128, d] with d <= 16.
    Returns [M, d] bf16."""
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
                       res_dual: bool = False):
    """Dispatch wrapper for the model code (counterpart of the JAX function
    of the same name).

    `w1` is the FULL first-layer kernel [(Σkᵢ), H] of the parameter tree; it
    is row-sliced per part here — by cumulative part widths, or by explicit
    `w1_rows` (o0, o1) spans when some rows of w1 were consumed by external
    projections (`pres`, already [M, H] in the first hidden basis). pres
    keep their incoming type. The row count M need not be a multiple of
    anything: the kernel masks its ragged tile."""
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
    parts16 = [p.to(dtype) for p in parts]
    w1s = [w1[o0:o1].to(dtype) for o0, o1 in w1_rows]
    fn = fused_mlp_ln_reference if plain_versions_active() else fused_mlp_ln
    return fn(parts16, w1s, b1, w2.to(dtype), b2, w3.to(dtype), b3, gamma,
              beta, tuple(pres), res_idx=res_idx, res_dual=res_dual)


def fused_mlp_noln_parts(x, w1, b1, w2, b2, w3, b3,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Dispatch wrapper for the Decoder: casts the stream and the weights;
    the narrow head is written as it is (no 128-lane padding)."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    fn = (fused_mlp_noln_reference if plain_versions_active()
          else fused_mlp_noln)
    return fn(x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2, w3.to(dtype),
              b3)
