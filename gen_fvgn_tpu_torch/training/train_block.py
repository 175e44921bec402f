"""Train step of the block engine.

Counterpart of `gen_fvgn_tpu/training/train_block.py`
(`init_train_state_block`, `make_train_step_block`, :26-164): forward with
normalizer accumulation, the log loss, the backward through the kernels'
backward passes (K1 on the stored transposes, K3, K4b, K5b, K7, and K9
where the NodeBlocks take the node pair), one Adam step with the learning
rate of `step_exp_lr(epoch)`. The batch is a stacked
DynamicPack; the case's StaticPack is shared. `MixedTrainStepBlock` and
`make_scan_train` belong to a later slice.

Batches above cfg.microbatch that divide into equal chunks run as
sequential gradient-accumulation chunks: the whole batch's normalizer
accumulation is hoisted out of the chunk loop (accumulate every row first,
then normalize every chunk with the updated statistics), and the gradient
is the mean over the chunks — the JAX step's semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
from gen_fvgn_tpu_torch.training import normalizer as norm_mod
from gen_fvgn_tpu_torch.training.forward import (ForwardOutputs,
                                                 training_loss)
from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
from gen_fvgn_tpu_torch.training.train import (StepMetrics, TrainState,
                                               global_norm, make_optimizer,
                                               step_exp_lr)
from gen_fvgn_tpu_torch.utils.device import resolve_device, same_device


def init_train_state_block(cfg: Config, seed: int = 0, device="cuda",
                           gather_pair: bool = False,
                           node_pair: bool = False):
    """(TrainState, simulator) for cfg.net on `device`: weights from
    torch.Generator().manual_seed(seed), a fresh Adam, the initial
    normalizer; `gather_pair` / `node_pair` as in `make_simulator_block`.
    (The JAX function also takes an example batch, from which flax shapes
    its parameters; the port's modules know their shapes from cfg.)
    device="cuda" without a card raises."""
    dev = resolve_device(device)
    sim = make_simulator_block(cfg, device=dev, seed=seed,
                               gather_pair=gather_pair, node_pair=node_pair)
    state = TrainState(
        simulator=sim, optimizer=make_optimizer(cfg, sim.parameters()),
        norm_state=init_normalizer(cfg.node_input_size - cfg.node_phi_size,
                                   device=dev))
    return state, sim


def _rows(dyn: DynamicPack, rows: torch.Tensor) -> DynamicPack:
    return DynamicPack(**{f.name: getattr(dyn, f.name).index_select(0, rows)
                          for f in dataclasses.fields(DynamicPack)})


def make_train_step_block(cfg: Config, simulator,
                          device="cuda") -> Callable:
    """(state, dyn_batch, static) -> (state, metrics, uvp_node_new).

    `state` is updated in place (parameters, optimizer moments, normalizer,
    step) and returned. `uvp_node_new` [B, Np, 3] is detached, for the
    pool's payback. Inside `ops.plain_versions()` forward and backward take
    the kernels' plain versions. device="cuda" without a card raises; the step refuses a batch on
    another device."""
    dev = resolve_device(device)
    schedule = step_exp_lr(cfg)
    params = [p for p in simulator.parameters()]

    def loss_and_grads(norm_state, dyn, static, accumulate):
        out = forward_batch_block(simulator, norm_state, dyn, static, cfg,
                                  accumulate_normalizer=accumulate)
        loss = training_loss(out, cfg)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads, out

    def grads_and_outputs(state: TrainState, dyn, static):
        b = dyn.uvp.shape[0]
        mb = cfg.microbatch
        n_dev = max(cfg.dp_devices, 1)
        eff_mb = mb * n_dev
        if not mb or b <= eff_mb or b % eff_mb:
            loss, grads, out = loss_and_grads(state.norm_state, dyn, static,
                                              True)
            return loss, grads, out.norm_state, out
        n_k = b // eff_mb
        norm_state = state.norm_state
        if cfg.norm_global:
            # the whole batch's accumulation, once, before any chunk
            n_pad = dyn.uvp.shape[1]
            theta_nodes = dyn.theta[:, None, :].expand(
                b, n_pad, dyn.theta.shape[-1])
            mask_b = static.node_mask[None].expand(b, n_pad)
            _, norm_state = norm_mod.normalize(
                norm_state, theta_nodes, mask_b,
                max_accumulations=float(cfg.dataset_size), accumulate=True)
        # the JAX row-to-chunk assignment: device-major blocks of mb rows
        order = torch.arange(b, device=dyn.uvp.device).reshape(
            n_dev, n_k, mb).permute(1, 0, 2).reshape(n_k, eff_mb)
        gacc = [torch.zeros_like(p) for p in params]
        lsum = torch.zeros((), dtype=torch.float32, device=dyn.uvp.device)
        outs = []
        for k in range(n_k):
            loss, grads, out = loss_and_grads(
                norm_state, _rows(dyn, order[k]), static, False)
            gacc = [a + g for a, g in zip(gacc, grads)]
            lsum = lsum + loss
            outs.append(out)
        grads = [g / n_k for g in gacc]
        inv = torch.argsort(order.reshape(-1))

        def cat(name):
            return torch.cat([getattr(o, name) for o in outs],
                             dim=0).index_select(0, inv)
        out = ForwardOutputs(
            loss_cont=cat("loss_cont"), loss_mom_x=cat("loss_mom_x"),
            loss_mom_y=cat("loss_mom_y"), loss_press=cat("loss_press"),
            uvp_node_new=cat("uvp_node_new"),
            uvp_cell_new=cat("uvp_cell_new"), norm_state=norm_state)
        return lsum / n_k, grads, norm_state, out

    def step(state: TrainState, dyn: DynamicPack, static: StaticPack):
        if not (same_device(dyn.uvp.device, dev)
                and same_device(static.node_mask.device, dev)):
            raise ValueError(f"the train step was made for {dev}, got a "
                             f"batch on {dyn.uvp.device}")
        with torch.enable_grad():
            loss, grads, norm_state, out = grads_and_outputs(state, dyn,
                                                             static)
        lr = schedule(state.epoch)
        opt = state.optimizer
        for group in opt.param_groups:
            group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        state.norm_state = norm_state
        state.step += 1
        metrics = StepMetrics(
            loss=loss, loss_cont=out.loss_cont.detach().mean(),
            loss_mom=(out.loss_mom_x + out.loss_mom_y).detach().mean(),
            loss_press=out.loss_press.detach().mean(),
            grad_norm=global_norm(grads), lr=lr)
        return state, metrics, out.uvp_node_new.detach()
    return step
