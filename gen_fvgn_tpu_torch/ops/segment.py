"""Masked segment primitives and row gathers on padded mesh graphs.

Counterpart of `gen_fvgn_tpu/ops/segment.py`. Every reduction takes a static
`num_segments` and an optional boolean mask that zeroes padding slots.
Where the JAX functions see one graph (the batch is a vmap around them),
these take batch-major tensors: `data` [B, M, ...] with `segment_ids`
[B, M] (each sample's own ids into its own [num_segments] rows). One
`index_add` covers the whole batch: sample b's ids are shifted by
b·num_segments into a flattened [B·num_segments] output.

The sums run in the data's type (a bf16 stream sums in bf16, as
`jax.ops.segment_sum` does) and are plain PyTorch: the JAX package computes
them with XLA's scatter-add, outside any Pallas kernel. On a card
`index_add` adds by atomics, so the order of a segment's additions, and so
the last bits of a sum, can change from run to run; `gather_rows` (whose
backward is an `index_add`) likewise. Padded slots index row 0 and read its
data; the mask zeroes what they contribute.
"""

from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(data: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.to(data.dtype)
    return data * m.reshape(m.shape + (1,) * (data.ndim - m.ndim))


def _flat_ids(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """Ids [B, M] into per-sample blocks of `rows` rows as ids into the
    flattened [B·rows] array."""
    offs = torch.arange(ids.shape[0], device=ids.device,
                        dtype=ids.dtype) * rows
    return (ids + offs[:, None]).reshape(-1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]]: x [B, N, ...] and idx [B, M] give [B, M, ...], the JAX
    code's `phi[idx]` on each graph."""
    rest = tuple(x.shape[2:])
    out = x.reshape((-1,) + rest).index_select(0, _flat_ids(idx, x.shape[1]))
    return out.reshape(tuple(idx.shape) + rest)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum `data[b, i]` into `out[b, segment_ids[b, i]]`; masked slots
    contribute 0. data [B, M, ...] with ids [B, M] gives [B, num_segments,
    ...], in data's type."""
    b = segment_ids.shape[0]
    rest = tuple(data.shape[2:])
    src = _apply_mask(data, mask).reshape((-1,) + rest)
    out = src.new_zeros((b * num_segments,) + rest).index_add(
        0, _flat_ids(segment_ids, num_segments), src)
    return out.reshape((b, num_segments) + rest)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean per segment counting only unmasked slots (count clamped to
    >= 1)."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = torch.ones(segment_ids.shape, dtype=data.dtype,
                      device=data.device)
    count = torch.clamp(segment_sum(ones, segment_ids, num_segments, mask),
                        min=1.0)
    return total / count.reshape(count.shape
                                 + (1,) * (total.ndim - count.ndim))


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
