"""MLP building blocks (torch.nn).

Counterpart of `gen_fvgn_tpu/models/mlp.py`: 2-hidden-layer GELU MLPs with
optional trailing LayerNorm, truncated-normal(0.02) weight init, zero bias.

The parameter layout is the flax tree's — hidden_i.{kernel,bias},
out.{kernel,bias}, ln.{scale,bias}, with `kernel` stored [in, out] — so a
converted checkpoint loads key by key and the per-part row slices of the
first layer stay simple. The compute dispatches between the layer-by-layer
path and the fused CUDA kernels (ops/fused_mlp.py) under the JAX package's
conditions (its process-wide on/off switch has no counterpart: nothing here
turns the kernels off): the fused kernels run in bfloat16 mode on the
standard 2-hidden-layer shape at widths that are multiples of 128;
everything else (the float32 parity suites, narrow test widths) uses the
unfused path.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from gen_fvgn_tpu_torch.ops.blocksparse import (apply_gather_pair,
                                                 apply_linop)


class Gathered(NamedTuple):
    """An MLP input part that is a row-gather of a smaller source array:
    part = gather(src) with `op` a LinOp ([rows ← src rows], take-indexed
    forward).

    The math is identical to passing gather(src) directly — row gathers
    commute exactly with the right-matmul by W1 — but the fused path
    projects `src` FIRST (src @ W1ᵢ on the small side) and gathers the
    projected rows, so the per-row matmul work moves from the gathered
    (edge) cardinality to the source (node) cardinality."""
    src: Any    # [(B,) Ns, w] source array
    op: Any     # LinOp with fwd.take_idx set, mapping [M ← Ns]


class GatheredPair(NamedTuple):
    """TWO consecutive Gathered parts sharing one source, fused: the
    contribution y[s_e, :H] + y[r_e, H:] (y = src @ [W1_a | W1_b]) comes
    from ONE pass of the pair-sum kernel K8 (`apply_gather_pair`) instead
    of two row-gathers and an add. `ops` is the MeshOperators bundle with
    gather_s / gather_r. It consumes TWO consecutive W1 row-blocks
    (2 × src width)."""
    src: Any    # [(B,) Ns, w] source array
    ops: Any    # MeshOperators


def _trunc_normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, mean=0.0, std=0.02, a=-0.04, b=0.04,
                          generator=generator)
    return w


class _DenseParams(nn.Module):
    """Parameters of one dense layer: kernel [in, out] (truncated normal, or
    orthogonal as flax's `initializers.orthogonal()`), bias [out] unless
    use_bias is False."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True, orthogonal: bool = False):
        super().__init__()
        if orthogonal:
            kernel = torch.empty((in_features, features))
            nn.init.orthogonal_(kernel, generator=generator)
        else:
            kernel = _trunc_normal((in_features, features), generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None


class _LnParams(nn.Module):
    """Parameters of a LayerNorm: scale, bias [features]."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


def _lanes(lead) -> int:
    """Batch lanes of a batch-major [B, M, ...] stream (1 unbatched): the
    fused kernels' backward rounds weight gradients per lane, as the JAX
    package's kernels do under the model's per-sample vmap."""
    return int(lead[0]) if len(lead) == 2 else 1


def _layer_norm(h, scale, bias, out_dtype, eps: float = 1e-6):
    """flax-equivalent LayerNorm (fast variance, float32 statistics)."""
    h32 = h.to(torch.float32)
    mu = h32.mean(dim=-1, keepdim=True)
    var = torch.clamp((h32 * h32).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    out = (h32 - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32) \
        + bias.to(torch.float32)
    return out.to(out_dtype)


def _materialize(p):
    """An input part as a tensor: a Gathered part gathered, a GatheredPair
    as its two gathers concatenated."""
    if isinstance(p, GatheredPair):
        return torch.cat([apply_linop(p.ops.gather_s, p.src),
                          apply_linop(p.ops.gather_r, p.src)], dim=-1)
    if isinstance(p, Gathered):
        return apply_linop(p.op, p.src)
    return p


class Mlp(nn.Module):
    """in_size → hidden → hidden → out_size, GELU (tanh form), optional LN.

    dtype: activation/matmul type (torch.bfloat16 or None for float32).
    residual_part: add parts[residual_part] to the output. With
    residual_dual the call returns (out, out + residual); otherwise just
    out + residual. The fused kernel emits the sum in its epilogue.
    """

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 num_hidden_layers: int = 2, layer_norm: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 residual_part: Optional[int] = None,
                 residual_dual: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_size = in_size
        self.hidden_size = hidden_size
        self.out_size = out_size
        self.num_hidden_layers = num_hidden_layers
        self.dtype = dtype
        self.residual_part = residual_part
        self.residual_dual = residual_dual
        in_feats = [in_size] + [hidden_size] * num_hidden_layers
        for i in range(num_hidden_layers):
            setattr(self, f"hidden_{i}",
                    _DenseParams(in_feats[i], hidden_size, generator))
        self.out = _DenseParams(in_feats[-1], out_size, generator)
        self.ln = _LnParams(out_size) if layer_norm else None

    def forward(self, x):
        """x: tensor, or a tuple of tensors / Gathered parts treated as
        concat(x, dim=-1) — the fused kernel consumes the parts directly so
        the concatenation never exists in device memory."""
        parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        widths = [2 * p.src.shape[-1] if isinstance(p, GatheredPair)
                  else p.src.shape[-1] if isinstance(p, Gathered)
                  else p.shape[-1] for p in parts]
        k_total = sum(widths)
        if k_total != self.in_size:
            raise ValueError(f"Mlp built for {self.in_size} input channels, "
                             f"got parts of total width {k_total}")
        hidden = [(getattr(self, f"hidden_{i}").kernel,
                   getattr(self, f"hidden_{i}").bias)
                  for i in range(self.num_hidden_layers)]
        w_out, b_out = self.out.kernel, self.out.bias
        ln = None if self.ln is None else (self.ln.scale, self.ln.bias)

        offs = [0]
        for w in widths:
            offs.append(offs[-1] + w)
        dt = self.dtype
        plain = [(p, (offs[i], offs[i + 1])) for i, p in enumerate(parts)
                 if not isinstance(p, (Gathered, GatheredPair))]
        if (dt == torch.bfloat16 and ln is not None
                and self.num_hidden_layers == 2 and plain
                and plain[0][0].ndim in (2, 3)
                and self.hidden_size % 128 == 0 and self.out_size % 128 == 0):
            return self._fused_ln(parts, plain, offs, k_total, hidden,
                                  w_out, b_out, ln)

        if (dt == torch.bfloat16 and ln is None
                and self.num_hidden_layers == 2 and len(parts) == 1
                and not isinstance(parts[0], (Gathered, GatheredPair))
                and parts[0].ndim in (2, 3) and k_total % 128 == 0
                and self.hidden_size % 128 == 0
                and self.residual_part is None):
            # no-LN fused chain (the Decoder)
            from gen_fvgn_tpu_torch.ops.fused_mlp import fused_mlp_noln_parts
            (w1, b1), (w2, b2) = hidden
            x0 = parts[0]
            lead = x0.shape[:-1]
            out = fused_mlp_noln_parts(x0.reshape(-1, x0.shape[-1]), w1, b1,
                                       w2, b2, w_out, b_out, dtype=dt,
                                       lanes=_lanes(lead))
            return out.reshape(lead + (out.shape[-1],))

        # ---- layer-by-layer path: the gathers materialized ----
        parts = tuple(_materialize(p) for p in parts)
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

        def dense(h, w, b):
            if dt is not None:
                h, w, b = h.to(dt), w.to(dt), b.to(dt)
            return h @ w + b

        h = x
        for w, b in hidden:
            h = F.gelu(dense(h, w, b), approximate="tanh")
        h = dense(h, w_out, b_out)
        if ln is not None:
            if dt == torch.bfloat16:
                h = _layer_norm(h, ln[0], ln[1], out_dtype=dt)
            else:
                h = _layer_norm(h.to(torch.float32), ln[0], ln[1],
                                out_dtype=torch.float32)
        if self.residual_part is not None:
            res = parts[self.residual_part]
            return (h, h + res) if self.residual_dual else h + res
        return h

    def _fused_ln(self, parts: Sequence, plain, offs, k_total, hidden, w_out,
                  b_out, ln):
        from gen_fvgn_tpu_torch.ops.fused_mlp import fused_mlp_ln_parts
        dt = self.dtype
        (w1, b1), (w2, b2) = hidden
        # batch-major layout [B, M, C]: the kernel sees the free
        # leading-axis collapse [B·M, C]
        lead = plain[0][0].shape[:-1]
        flat = lambda a: a.reshape(-1, a.shape[-1])
        unflat = lambda o: o.reshape(lead + (o.shape[-1],))

        def project(src, w_rows):
            # float32 accumulation, ONE bf16 rounding (plain matmul outside
            # the kernel, as the JAX package leaves it to XLA)
            return (src.to(dt).to(torch.float32)
                    @ w_rows.to(dt).to(torch.float32)).to(dt)

        if (len(plain) == len(parts) and k_total <= 64
                and self.residual_part is None):
            # NARROW-input form (the encoders: 12/15-channel inputs):
            # project into the first hidden basis at the natural width
            # outside the kernel and feed the kernel its pres-only form
            xcat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            pre = project(xcat, w1)
            out = fused_mlp_ln_parts(
                [], w1, b1, w2, b2, w_out, b_out, ln[0], ln[1], dtype=dt,
                pres=(flat(pre),), w1_rows=[], lanes=_lanes(lead))
            return unflat(out)

        # a GatheredPair: project the source into BOTH halves' first-layer
        # bases with one product, lane halves [ys | yr], then one pass of
        # the pair-sum kernel. Gathered parts: project the source by its W1
        # row-slice at source cardinality — one product PER part, so the
        # gather reads full rows — then row-gather the projection;
        # contributions sum in bf16
        pre = None
        for i, p in enumerate(parts):
            if isinstance(p, GatheredPair):
                o0, o1 = offs[i], offs[i + 1]
                half = (o1 - o0) // 2
                w1cat = torch.cat([w1[o0:o0 + half], w1[o0 + half:o1]],
                                  dim=-1)
                contrib = apply_gather_pair(p.ops, project(p.src, w1cat))
            elif isinstance(p, Gathered):
                y = project(p.src, w1[offs[i]:offs[i + 1]])
                contrib = apply_linop(p.op, y)
            else:
                continue
            pre = contrib if pre is None else pre + contrib
        res_plain = None
        if self.residual_part is not None:
            res_plain = [i for i, (p, _) in enumerate(plain)
                         if p is parts[self.residual_part]][0]
        out = fused_mlp_ln_parts(
            [flat(p) for p, _ in plain], w1, b1, w2, b2, w_out, b_out,
            ln[0], ln[1], dtype=dt,
            pres=() if pre is None else (flat(pre),),
            w1_rows=[rows for _, rows in plain],
            res_idx=res_plain, res_dual=self.residual_dual,
            lanes=_lanes(lead))
        return (tuple(unflat(o) for o in out) if isinstance(out, tuple)
                else unflat(out))
