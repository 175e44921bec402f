"""Train state, learning-rate schedule, optimizer, and the segment
engine's train step.

Counterpart of `gen_fvgn_tpu/training/train.py` (`step_exp_lr`,
`TrainState`, `StepMetrics`, `_make_optimizer`, `init_train_state`,
`make_train_step`). The optimizer is `torch.optim.Adam` with optax's
defaults (β 0.9 / 0.999, eps 1e-8 added outside the square root), the
counterpart of `optax.inject_hyperparams(optax.adam)`: the learning rate is
written into the parameter group from `step_exp_lr(epoch)` before every
step (`apply_update`, shared with the block engine's steps). The segment
step takes the whole batch at once, as the JAX step does (no microbatch
chunking).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.training.normalizer import (NormalizerState,
                                                    init_normalizer)
from gen_fvgn_tpu_torch.utils.device import resolve_device, same_device


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


def apply_update(state: TrainState, params, grads, lr: float) -> None:
    """One Adam step of `state.optimizer` on `params` with `grads` at
    learning rate `lr` (written into every parameter group first)."""
    opt = state.optimizer
    for group in opt.param_groups:
        group["lr"] = lr
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def step_metrics(loss, out, grads, lr: float) -> StepMetrics:
    """The step's metrics from its loss, ForwardOutputs and gradients."""
    return StepMetrics(
        loss=loss, loss_cont=out.loss_cont.detach().mean(),
        loss_mom=(out.loss_mom_x + out.loss_mom_y).detach().mean(),
        loss_press=out.loss_press.detach().mean(),
        grad_norm=global_norm(grads), lr=lr)


def init_train_state(cfg: Config, seed: int = 0, device="cuda"):
    """(TrainState, simulator) of the segment engine for cfg.net on
    `device`: weights from torch.Generator().manual_seed(seed), a fresh
    Adam, the initial normalizer. (The JAX function also takes an example
    batch, from which flax shapes its parameters; the port's modules know
    their shapes from cfg.) device="cuda" without a card raises."""
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    dev = resolve_device(device)
    sim = make_simulator(cfg, device=dev, seed=seed)
    state = TrainState(
        simulator=sim, optimizer=make_optimizer(cfg, sim.parameters()),
        norm_state=init_normalizer(cfg.node_input_size - cfg.node_phi_size,
                                   device=dev))
    return state, sim


def make_train_step(cfg: Config, simulator, device="cuda") -> Callable:
    """(state, batch) -> (state, metrics, uvp_node_new) for a stacked
    MeshSample batch: forward with normalizer accumulation, the log loss,
    its backward, one Adam step at `step_exp_lr(state.epoch)`. `state` is
    updated in place and returned; `uvp_node_new` [B, Np, 3] is detached,
    for the pool's payback. device="cuda" without a card raises; the step
    refuses a batch on another device."""
    from gen_fvgn_tpu_torch.training.forward import (forward_batch,
                                                     training_loss)
    dev = resolve_device(device)
    schedule = step_exp_lr(cfg)
    params = list(simulator.parameters())

    def step(state: TrainState, batch):
        if not same_device(batch.uvp.device, dev):
            raise ValueError(f"the train step was made for {dev}, got a "
                             f"batch on {batch.uvp.device}")
        with torch.enable_grad():
            out = forward_batch(simulator, state.norm_state, batch, cfg,
                                accumulate_normalizer=True)
            loss = training_loss(out, cfg)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        lr = schedule(state.epoch)
        apply_update(state, params, grads, lr)
        state.norm_state = out.norm_state
        state.step += 1
        return (state, step_metrics(loss.detach(), out, grads, lr),
                out.uvp_node_new.detach())
    return step
