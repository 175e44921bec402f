"""Train steps of the block engine.

Counterpart of `gen_fvgn_tpu/training/train_block.py`
(`init_train_state_block`, `make_train_step_block`, :26-164, and
`MixedTrainStepBlock`, :167-324, on one device): forward with
normalizer accumulation, the log loss, the backward through the kernels'
backward passes (K1 on the stored transposes, K3, K4b, K5b, K7, and K9
where the NodeBlocks take the node pair), one Adam step with the learning
rate of `step_exp_lr(epoch)`. The batch is a stacked
DynamicPack; the case's StaticPack is shared. A mixed-case batch runs as
`MixedTrainStepBlock`: one step over per-case groups. `make_scan_train`,
which only timed steps inside one jit for the TPU benchmark, is not
ported.

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
                                                 training_loss,
                                                 training_loss_weighted)
from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
from gen_fvgn_tpu_torch.training.normalizer import (NormalizerState,
                                                    init_normalizer)
from gen_fvgn_tpu_torch.training.train import (StepMetrics, TrainState,
                                               apply_update, global_norm,
                                               make_optimizer, step_exp_lr,
                                               step_metrics)
from gen_fvgn_tpu_torch.utils.device import (resolve_device, same_device,
                                             to_device)


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
        apply_update(state, params, grads, lr)
        state.norm_state = norm_state
        state.step += 1
        return (state, step_metrics(loss, out, grads, lr),
                out.uvp_node_new.detach())
    return step


class MixedTrainStepBlock:
    """One train step over a mixed-case batch (cfg.mixed_case_batches): a
    list of per-case groups, each with its own StaticPack, from
    `EnvPool.mixed_block_batches`. The step runs in pieces and equals the
    step on the whole mixed batch:

      1. `group_stats` per group, then `norm_update` once: the batch's
         normalizer accumulation over every real row, ahead of any forward
         (accumulate first, then normalize with the updated statistics;
         num_acc advances once a step, as in the single-case step);
      2. `group_grads` per group: the weighted-sum log loss (1/B on real
         rows, 0 on pads), its gradients summed into one accumulator;
      3. `apply_update` once: the learning rate of `step_exp_lr(epoch)` and
         one Adam step.

    Each group runs the same forward and backward as a single-case step,
    so a group launches the kernels a train step launches."""

    def __init__(self, cfg: Config, simulator, device="cuda"):
        self.cfg = cfg
        self.dev = resolve_device(device)
        self.schedule = step_exp_lr(cfg)
        self.simulator = simulator
        self.params = list(simulator.parameters())
        self.n_feat = cfg.node_input_size - cfg.node_phi_size

    def init_sums(self):
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=self.dev)
        return z(self.n_feat), z(self.n_feat), z()

    def group_stats(self, sums, dyn: DynamicPack, static: StaticPack,
                    weights: torch.Tensor):
        """`sums` (Σ θ, Σ θ², row count) plus the group's real rows."""
        b, n_pad = dyn.uvp.shape[:2]
        theta_nodes = dyn.theta[:, None, :].expand(b, n_pad,
                                                   dyn.theta.shape[-1])
        m = (static.node_mask[None].to(torch.float32)
             * (weights > 0).to(torch.float32)[:, None])      # [b, n_pad]
        flat = theta_nodes * m[..., None]
        return (sums[0] + flat.sum(dim=(0, 1)),
                sums[1] + (flat ** 2).sum(dim=(0, 1)),
                sums[2] + m.sum())

    def norm_update(self, norm_state: NormalizerState, sums):
        """One accumulation's update of the normalizer with the whole
        batch's sums (`normalizer.normalize`'s accumulate branch)."""
        should = (norm_state.num_acc
                  < float(self.cfg.dataset_size)).to(torch.float32)
        return NormalizerState(
            acc_sum=norm_state.acc_sum + should * sums[0],
            acc_sum_sq=norm_state.acc_sum_sq + should * sums[1],
            acc_count=norm_state.acc_count + should * sums[2],
            num_acc=norm_state.num_acc + should)

    def init_acc(self):
        z = lambda: torch.zeros((), dtype=torch.float32, device=self.dev)
        return {"gsum": [torch.zeros_like(p) for p in self.params],
                "loss": z(), "cont": z(), "mom": z(), "press": z()}

    def group_grads(self, norm_state, acc, dyn: DynamicPack,
                    static: StaticPack, weights: torch.Tensor):
        """The group's weighted loss and gradients added into `acc`;
        returns (acc, the group's new states [b, Np, 3], detached)."""
        with torch.enable_grad():
            out = forward_batch_block(self.simulator, norm_state, dyn, static,
                                      self.cfg, accumulate_normalizer=False)
            loss_w = training_loss_weighted(out, self.cfg, weights)
            grads = torch.autograd.grad(loss_w, self.params,
                                        allow_unused=True)
        w = weights.reshape(-1, 1)
        acc = {
            "gsum": [a if g is None else a + g
                     for a, g in zip(acc["gsum"], grads)],
            "loss": acc["loss"] + loss_w.detach(),
            "cont": acc["cont"] + torch.sum(w * out.loss_cont.detach()),
            "mom": acc["mom"] + torch.sum(
                w * (out.loss_mom_x + out.loss_mom_y).detach()),
            "press": acc["press"] + torch.sum(w * out.loss_press.detach()),
        }
        return acc, out.uvp_node_new.detach()

    def apply_update(self, state: TrainState, acc, norm_state):
        """One Adam step with the summed gradients; `state` is updated in
        place and returned with the step's metrics."""
        lr = self.schedule(state.epoch)
        apply_update(state, self.params, acc["gsum"], lr)
        state.norm_state = norm_state
        state.step += 1
        metrics = StepMetrics(
            loss=acc["loss"], loss_cont=acc["cont"], loss_mom=acc["mom"],
            loss_press=acc["press"], grad_norm=global_norm(acc["gsum"]),
            lr=lr)
        return state, metrics

    def run_batch(self, state: TrainState, batch, gather, statics,
                  payback=None):
        """One step on `batch` (an element of `mixed_block_batches`: [(ci,
        idxs, weights, n_real), ...]); `gather(idxs)` gives a group's
        DynamicPack and `payback(idxs, uvp)`, where given, takes each
        group's real rows. Returns (state, metrics)."""
        weights = [to_device(w, self.dev) for _, _, w, _ in batch]
        norm_state = state.norm_state
        if self.cfg.norm_global:
            sums = self.init_sums()
            for (ci, idxs, _, _), w in zip(batch, weights):
                sums = self.group_stats(sums, gather(idxs), statics[ci], w)
            norm_state = self.norm_update(norm_state, sums)
        acc = self.init_acc()
        for (ci, idxs, _, g), w in zip(batch, weights):
            acc, uvp_new = self.group_grads(norm_state, acc, gather(idxs),
                                            statics[ci], w)
            if payback is not None:
                payback(idxs[:g], uvp_new[:g])
        return self.apply_update(state, acc, norm_state)
