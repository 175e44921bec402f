"""Train state, learning-rate schedule, optimizer and step metrics.

Counterpart of `gen_fvgn_tpu/training/train.py` (`step_exp_lr`,
`TrainState`, `StepMetrics`, `_make_optimizer`, :29-71). The optimizer is
`torch.optim.Adam` with optax's defaults (β 0.9 / 0.999, eps 1e-8 added
outside the square root), the counterpart of
`optax.inject_hyperparams(optax.adam)`: the learning rate is written into
the parameter group from `step_exp_lr(epoch)` before every step. The
segment-engine `init_train_state` / `make_train_step` belong to a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState


def step_exp_lr(cfg: Config) -> Callable[[int], float]:
    """3-phase schedule of the EPOCH index: constant, stepped constant
    (gamma 1 at 10% of the epochs), then exponential decay (gamma 0.1 over
    the second half) towards min_lr. Evaluated in float32, as the JAX
    schedule is, and returned as that float32 value."""
    f32 = np.float32
    steplr_milestone = int(cfg.n_epochs * 0.1)
    explr_milestone = int(cfg.n_epochs * 0.5)
    base = cfg.lr * 1.0
    decay_steps = max(cfg.n_epochs - explr_milestone, 1)

    def schedule(epoch) -> float:
        e = f32(epoch)
        if e < steplr_milestone:
            return float(f32(cfg.lr))
        if e < explr_milestone:
            return float(f32(base))
        progress = (e - f32(explr_milestone)) / f32(decay_steps)
        decayed = f32(cfg.min_lr) + f32(max(base - cfg.min_lr, 0.0)) \
            * np.power(f32(0.1), progress)
        return float(f32(decayed))

    return schedule


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    loss_cont: torch.Tensor
    loss_mom: torch.Tensor
    loss_press: torch.Tensor
    grad_norm: torch.Tensor
    lr: float


@dataclass
class TrainState:
    """What a training run carries from step to step. The simulator's
    parameters live in `simulator` and are updated in place by
    `optimizer` (the JAX step donates its state instead)."""
    simulator: nn.Module
    optimizer: torch.optim.Optimizer
    norm_state: NormalizerState
    step: int = 0               # inner optimization steps taken
    epoch: int = 0              # outer epoch counter (drives the LR schedule)


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam with optax's defaults; the learning rate is set per step."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ Σ g²) over the tensors, float32 (`optax.global_norm`)."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2)
                          for t in tensors))
