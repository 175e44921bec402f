"""Physics attention over learned slice tokens (graph Transolver).

Counterpart of `gen_fvgn_tpu/models/transolver.py`, with the same parameter
tree. Tensors are batch-major ([B, N, C], or unbatched [N, C]); the node
mask is [N] (shared by the batch, as the block engine's StaticPack holds
it) or [B, N].

Both forms of the JAX package are kept, because they round at different
places:

- the fused form (bf16 stream, C % 128 == 0, H·G % 128 == 0, H·D == C,
  N % 256 == 0 — the JAX dispatch conditions): the per-node half of the
  attention runs as kernel K6 (ops/fused_slice_attn.py), the slice weights
  are stored bf16, and the de-slice is folded with `to_out` into one
  [N, H·G] @ [H·G, C] product; the block's pre-LN MLP branch and its
  residual run as kernel K5f (ops/fused_mlp.py) in bf16 at widths that are
  multiples of 128;
- the plain-layer form otherwise: dense layers and einsum pooling/de-slice
  as the flax `nn.Dense`/`nn.LayerNorm` path.

The JAX package's process-wide `use_fused_attn` switch has no counterpart:
the fused form runs whenever its conditions hold, N being the whole
mesh's node count under spatial parallelism. There (`parallel/sp.py`)
each rank pools its own node rows (K6, or the plain einsums) and the
unnormalised tokens and slice norms are summed over the sp group before
the division; the G-token attention is then the same on every rank and
the de-slice is row-local. (JAX takes its plain form under sp; both forms
compute the same function.) `to_q`/`to_k`/`to_v`, the
G-token attention and the folded de-slice product are plain torch ops in
both forms (the JAX package leaves them to XLA outside any kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from gen_fvgn_tpu_torch.models.mlp import _DenseParams, _LnParams
from gen_fvgn_tpu_torch.ops.blocksparse import sp_layout
from gen_fvgn_tpu_torch.parallel.sp import sp_sum
from gen_fvgn_tpu_torch.utils.spans import span


def _flax_layer_norm(h, scale, bias, out_dtype, eps: float = 1e-6):
    """flax `nn.LayerNorm` in its own rounding order (fast variance,
    float32 statistics): (x − μ) · (rstd · γ) + β. `models/mlp.py::
    _layer_norm` rounds as ((x − μ) · rstd) · γ + β, which is right for
    `Mlp`, whose JAX counterpart writes it out that way."""
    h32 = h.to(torch.float32)
    mu = h32.mean(dim=-1, keepdim=True)
    var = torch.clamp((h32 * h32).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * scale.to(torch.float32)
    return ((h32 - mu) * mul + bias.to(torch.float32)).to(out_dtype)


def _dense(h, p: _DenseParams, dt: Optional[torch.dtype]):
    """flax `nn.Dense(dtype=dt)`: inputs and parameters cast to dt, the
    product accumulated in float32 and rounded once to dt, then the bias
    added in dt. dt None: float32 throughout."""
    if dt is None:
        y = h @ p.kernel
        return y if p.bias is None else y + p.bias
    y = (h.to(dt).to(torch.float32) @ p.kernel.to(dt).to(torch.float32)
         ).to(dt)
    return y if p.bias is None else y + p.bias.to(dt)


class PhysicsAttention(nn.Module):
    """Slice-token attention. forward(x [(B,) N, C], node_mask [N] or
    [B, N]) -> [(B,) N, C] in the stream type."""

    def __init__(self, hidden_dim: int, heads: int = 8, slice_num: int = 32,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim, self.heads, self.slice_num = hidden_dim, heads, \
            slice_num
        self.dtype = dtype
        d = hidden_dim // heads
        self.graph_temperature = nn.Parameter(torch.full((1, heads, 1), 0.5))
        self.in_project_fx = _DenseParams(hidden_dim, heads * d, generator)
        self.in_project_x = _DenseParams(hidden_dim, heads * d, generator)
        self.in_project_slice = _DenseParams(d, slice_num, generator,
                                             orthogonal=True)
        self.to_q = _DenseParams(d, d, generator, use_bias=False)
        self.to_k = _DenseParams(d, d, generator, use_bias=False)
        self.to_v = _DenseParams(d, d, generator, use_bias=False)
        self.to_out = _DenseParams(heads * d, hidden_dim, generator)

    def fused(self, n: int, c: int) -> bool:
        h, g = self.heads, self.slice_num
        return (self.dtype == torch.bfloat16 and c % 128 == 0
                and (h * g) % 128 == 0 and h * (self.hidden_dim // h) == c
                and n % 256 == 0)

    def forward(self, x, node_mask):
        n, c = x.shape[-2:]
        h, g = self.heads, self.slice_num
        d = self.hidden_dim // h
        dt, f32 = self.dtype, torch.float32
        x3 = x.reshape(-1, n, c)
        b = x3.shape[0]
        sp = sp_layout()
        if self.fused(n * (sp.sp if sp is not None else 1), c):
            from gen_fvgn_tpu_torch.ops.fused_slice_attn import \
                fused_slice_pool
            p_fx, p_x, p_sl = (self.in_project_fx, self.in_project_x,
                               self.in_project_slice)
            inv_temp = (1.0 / self.graph_temperature).reshape(h)
            slice_w, tok, norm = fused_slice_pool(
                x3, node_mask, p_fx.kernel, p_fx.bias, p_x.kernel, p_x.bias,
                p_sl.kernel, p_sl.bias, inv_temp, heads=h, slice_num=g)
            if sp is not None:
                tok, norm = sp_sum(tok), sp_sum(norm)
            token = tok / (norm[..., None] + 1e-5)          # [B, H, G, D]
        else:
            fx_mid = _dense(x3, self.in_project_fx, dt).reshape(b, n, h, d)
            x_mid = _dense(x3, self.in_project_x, dt).reshape(b, n, h, d)
            logits = _dense(x_mid, self.in_project_slice, dt)  # [B,N,H,G]
            slice_w = torch.softmax(logits.to(f32) / self.graph_temperature,
                                    dim=-1)
            mask = node_mask.to(f32).reshape(-1, n, 1, 1)
            slice_w_masked = slice_w * mask
            slice_norm = slice_w_masked.sum(dim=1)           # [B, H, G]
            token = torch.einsum("bnhg,bnhd->bhgd", slice_w_masked,
                                 fx_mid.to(f32))
            if sp is not None:
                token, slice_norm = sp_sum(token), sp_sum(slice_norm)
            token = token / (slice_norm[..., None] + 1e-5)

        q = _dense(token, self.to_q, dt)
        k = _dense(token, self.to_k, dt)
        v = _dense(token, self.to_v, dt)
        dots = torch.einsum("bhgd,bhkd->bhgk", q.to(f32), k.to(f32)) \
            * d ** -0.5
        attn = torch.softmax(dots, dim=-1)
        out_token = torch.einsum("bhgk,bhkd->bhgd", attn, v.to(f32))

        if slice_w.ndim == 3:
            # fused form: de-slice + out projection as ONE product,
            # slice_w @ (BD(out_token) @ W_out) + b, with BD the [H·G, C]
            # head-block-diagonal embed of the attended tokens
            w_out = self.to_out.kernel.to(f32).reshape(h, d, c)
            m2 = torch.einsum("bhgd,hdc->bhgc", out_token, w_out) \
                .reshape(b, h * g, c).to(dt)
            out = torch.bmm(slice_w.to(f32), m2.to(f32)) \
                + self.to_out.bias.to(f32)
            return out.to(dt).reshape(x.shape)
        out_x = torch.einsum("bnhg,bhgd->bnhd", slice_w, out_token)
        return _dense(out_x.reshape(b, n, h * d), self.to_out, dt) \
            .reshape(x.shape[:-1] + (self.hidden_dim,))


class TransolverBlock(nn.Module):
    """Attention + 2-layer GELU MLP with pre-LN on the MLP branch only.
    forward(x [(B,) N, C], node_mask) -> [(B,) N, C]."""

    def __init__(self, hidden_dim: int, heads: int = 8, slice_num: int = 32,
                 mlp_ratio: int = 2, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim, self.mlp_ratio, self.dtype = hidden_dim, mlp_ratio, \
            dtype
        self.attn = PhysicsAttention(hidden_dim, heads, slice_num, dtype,
                                     generator)
        self.ln_2 = _LnParams(hidden_dim)
        self.mlp_pre = _DenseParams(hidden_dim, hidden_dim * mlp_ratio,
                                    generator)
        self.mlp_post = _DenseParams(hidden_dim * mlp_ratio, hidden_dim,
                                     generator)

    def forward(self, x, node_mask):
        with span("gfvgn.model.attention"):
            return self._forward(x, node_mask)

    def _forward(self, x, node_mask):
        x = self.attn(x, node_mask) + x
        c, hd, dt = self.hidden_dim, self.hidden_dim * self.mlp_ratio, \
            self.dtype
        ln, pre, post = self.ln_2, self.mlp_pre, self.mlp_post
        if dt == torch.bfloat16 and c % 128 == 0 and hd % 128 == 0:
            # pre-LN MLP branch + residual as ONE kernel (K5f)
            from gen_fvgn_tpu_torch.ops.fused_mlp import fused_premlp_res_parts
            return fused_premlp_res_parts(x, ln.scale, ln.bias, pre.kernel,
                                          pre.bias, post.kernel, post.bias,
                                          dtype=dt)
        if dt == torch.bfloat16:
            h = _flax_layer_norm(x, ln.scale, ln.bias, out_dtype=dt)
        else:
            h = _flax_layer_norm(x.to(torch.float32), ln.scale, ln.bias,
                                 out_dtype=torch.float32)
        h = F.gelu(_dense(h, pre, dt), approximate="tanh")
        return x + _dense(h, post, dt)
