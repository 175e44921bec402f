"""Running (online) feature normalizer as explicit state.

Counterpart of `gen_fvgn_tpu/training/normalizer.py`: an accumulating
mean/std with a capped number of accumulations and an std floor, kept as a
plain dataclass of tensors that travels beside the model's parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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


def normalize(state: NormalizerState, rows: torch.Tensor,
              row_mask: torch.Tensor, max_accumulations: float,
              accumulate: bool = True
              ) -> Tuple[torch.Tensor, NormalizerState]:
    """Normalize `rows` [..., F] with the running statistics, optionally
    accumulating the (masked) rows first — accumulate, then normalize with
    the UPDATED stats."""
    if accumulate:
        should = (state.num_acc < max_accumulations).to(torch.float32)
        m = row_mask.to(torch.float32).reshape(row_mask.shape + (1,))
        flat = (rows * m).reshape(-1, rows.shape[-1])
        count = row_mask.to(torch.float32).sum()
        state = NormalizerState(
            acc_sum=state.acc_sum + should * flat.sum(dim=0),
            acc_sum_sq=state.acc_sum_sq + should * (flat ** 2).sum(dim=0),
            acc_count=state.acc_count + should * count,
            num_acc=state.num_acc + should,
        )
    mean, std = _mean_std(state)
    return (rows - mean) / std, state

