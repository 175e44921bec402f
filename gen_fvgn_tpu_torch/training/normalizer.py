"""Running (online) feature normalizer as explicit state.

Counterpart of `gen_fvgn_tpu/training/normalizer.py`: an accumulating
mean/std with a capped number of accumulations and an std floor, kept as a
plain dataclass of tensors that travels beside the model's parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from gen_fvgn_tpu_torch.utils.device import resolve_device


@dataclass
class NormalizerState:
    acc_sum: torch.Tensor        # [F]
    acc_sum_sq: torch.Tensor     # [F]
    acc_count: torch.Tensor      # [] — number of accumulated rows (init 1.0)
    num_acc: torch.Tensor        # [] — number of accumulate() calls (init 1.0)

    def to(self, device) -> "NormalizerState":
        return NormalizerState(self.acc_sum.to(device),
                               self.acc_sum_sq.to(device),
                               self.acc_count.to(device),
                               self.num_acc.to(device))


def init_normalizer(size: int, device="cuda") -> NormalizerState:
    dev = resolve_device(device)
    return NormalizerState(
        acc_sum=torch.zeros((size,), dtype=torch.float32, device=dev),
        acc_sum_sq=torch.zeros((size,), dtype=torch.float32, device=dev),
        acc_count=torch.tensor(1.0, dtype=torch.float32, device=dev),
        num_acc=torch.tensor(1.0, dtype=torch.float32, device=dev),
    )


def _mean_std(state: NormalizerState, epsilon: float = 1e-8):
    count = torch.clamp(state.acc_count, min=1.0)
    mean = state.acc_sum / count
    var = state.acc_sum_sq / count - mean ** 2
    std = torch.sqrt(torch.clamp(var, min=0.0))
    std = torch.where(std < epsilon, torch.ones_like(std), std)
    return mean, std


def reduce_sums(sums, reduce: Optional[Callable] = None):
    """(Σx [F], Σx² [F], count []) through `reduce` as ONE packed [2F+1]
    vector (data parallelism passes the all-reduce over the ranks, so that
    the statistics are the global batch's); unchanged where `reduce` is
    None."""
    if reduce is None:
        return sums
    s, s2, count = sums
    f = s.shape[0]
    packed = reduce(torch.cat([s, s2, count.reshape(1)]))
    return packed[:f], packed[f:2 * f], packed[2 * f]


def normalize(state: NormalizerState, rows: torch.Tensor,
              row_mask: torch.Tensor, max_accumulations: float,
              accumulate: bool = True, reduce: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, NormalizerState]:
    """Normalize `rows` [..., F] with the running statistics, optionally
    accumulating the (masked) rows first — accumulate, then normalize with
    the UPDATED stats. `reduce` takes the packed sums of the rows before
    the update (`reduce_sums`)."""
    if accumulate:
        should = (state.num_acc < max_accumulations).to(torch.float32)
        m = row_mask.to(torch.float32).reshape(row_mask.shape + (1,))
        flat = (rows * m).reshape(-1, rows.shape[-1])
        s, s2, count = reduce_sums(
            (flat.sum(dim=0), (flat ** 2).sum(dim=0),
             row_mask.to(torch.float32).sum()), reduce)
        state = NormalizerState(
            acc_sum=state.acc_sum + should * s,
            acc_sum_sq=state.acc_sum_sq + should * s2,
            acc_count=state.acc_count + should * count,
            num_acc=state.num_acc + should,
        )
    mean, std = _mean_std(state)
    return (rows - mean) / std, state


def inverse(state: NormalizerState, normalized: torch.Tensor) -> torch.Tensor:
    """The rows `normalize` would map to `normalized`, with the current
    statistics."""
    mean, std = _mean_std(state)
    return normalized * std + mean

