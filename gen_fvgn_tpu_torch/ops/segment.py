"""Masked reductions used around the backbone.

Counterpart of `gen_fvgn_tpu/ops/segment.py`, cut to what the block engine
uses (`masked_mean_var`, `safe_sqrt`); the scatter-form segment sums belong
to the segment engine, a later slice.
"""

from __future__ import annotations

import torch


def masked_mean_var(x: torch.Tensor, mask: torch.Tensor, axis: int = 0):
    """Mean and (biased) variance of `x` over `axis`, counting only rows
    where `mask` is True. Used for per-graph feature standardization."""
    m = mask.to(x.dtype).reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
    count = torch.clamp(m.sum(dim=axis, keepdim=True), min=1.0)
    mean = (x * m).sum(dim=axis, keepdim=True) / count
    var = (((x - mean) ** 2) * m).sum(dim=axis, keepdim=True) / count
    return mean, var


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (not inf/nan) gradient at x == 0: value
    sqrt(max(x,0)), derivative 0 at the origin."""
    safe = torch.where(x > 0.0, x, torch.ones_like(x))
    return torch.where(x > 0.0, torch.sqrt(safe), torch.zeros_like(x))
