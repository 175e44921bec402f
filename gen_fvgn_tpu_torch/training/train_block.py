"""Train steps of the block engine.

Counterpart of `gen_fvgn_tpu/training/train_block.py`
(`init_train_state_block`, `make_train_step_block`, :26-164, and
`MixedTrainStepBlock`, :167-324): forward with
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

Data parallelism (`dp=True`; the JAX steps jitted over a dp-sharded
batch): every rank calls a step on its own contiguous rows of the global
batch (`parallel.dp.local_rows`). The normalizer accumulates the global
batch's sums (one all-reduce of the packed sums), the gradients are
all-reduced before Adam (the rank's mean loss's with scale 1/world; the
mixed step's weighted sums with scale 1), the metrics are the global
batch's, and the new states come back for the rank's own rows. The
caller gathers the global batch's states only where the pool is paid
back (`parallel.dp.all_gather_rows`), so that every rank's pool stays the
same; the mixed step's `run_batch` does so for its `payback`.
Under microbatching the JAX step decides on the global batch against
microbatch × dp_devices and gives device r's chunk k the rows k·mb to
(k+1)·mb of its own block: rank r's chunk k holds the same rows.

Spatial parallelism (`sp=True`; the JAX steps under an sp mesh, with the
statics `shard_static_sp`-ed): over the (dp, sp) layout of
`parallel.sp.groups`, the step takes the rank's batch rows (over dp) of
its node rows (over sp, `parallel.sp.local_rows_sp`) against the rank's
cut of the StaticPack, and runs inside `parallel.sp.sp_context`: every
apply gathers its operand over the sp group, and every sum over rows is
all-reduced there (`parallel.sp.sp_sum`, whose backward is an all-reduce
too). Every rank of an sp group thus holds the same loss, and its
gradients are its rows' share times sp_devices; the step sums them over
the world with the scale 1 / (dp·sp), as it does under dp alone. The
normalizer's sums are reduced over the world, and the new states come
back for the rank's rows (`parallel.sp.gather_states` assembles the
global batch's for the payback).
"""

from __future__ import annotations

import dataclasses
import contextlib
from typing import Callable

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
from gen_fvgn_tpu_torch.parallel import dp as dp_mod
from gen_fvgn_tpu_torch.parallel import sp as sp_mod
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
from gen_fvgn_tpu_torch.utils.spans import span


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


def microbatch_order(b: int, mb: int, n_dev: int):
    """The JAX step's row-to-chunk assignment of a batch of `b` rows laid
    out as `n_dev` contiguous device blocks: [n_k, n_dev·mb], chunk k
    holding rows k·mb to (k+1)·mb of every block, device-major; None where
    the batch runs unchunked (mb 0, b at most mb·n_dev, or not divisible
    into equal chunks)."""
    eff_mb = mb * n_dev
    if not mb or b <= eff_mb or b % eff_mb:
        return None
    n_k = b // eff_mb
    return torch.arange(b).reshape(n_dev, n_k, mb).permute(1, 0, 2) \
        .reshape(n_k, eff_mb)


def _sp_layout(cfg: Config, sp: bool):
    """The current (dp, sp) layout for an sp step, checked against cfg;
    None without sp."""
    if not sp:
        return None
    lay = sp_mod.layout()
    if (lay.dp, lay.sp) != (max(cfg.dp_devices, 1), cfg.sp_devices):
        raise ValueError(f"the sp layout is dp {lay.dp} x sp {lay.sp}, the "
                         f"Config dp_devices {cfg.dp_devices} x sp_devices "
                         f"{cfg.sp_devices}")
    return lay


def make_train_step_block(cfg: Config, simulator, device="cuda",
                          dp: bool = False, sp: bool = False) -> Callable:
    """(state, dyn_batch, static) -> (state, metrics, uvp_node_new).

    `state` is updated in place (parameters, optimizer moments, normalizer,
    step) and returned. `uvp_node_new` [B, Np, 3] is detached, for the
    pool's payback. With `dp`, `dyn_batch` is this rank's rows of the
    global batch and the step is the global batch's (the module's
    docstring); `uvp_node_new` is then this rank's rows. With `sp`,
    `dyn_batch` and `static` are also cut to the rank's node rows (the
    layout of `parallel.sp.groups`, which must match cfg, and whose dp
    decides `dp`), and so is `uvp_node_new`. Inside `ops.plain_versions()` forward and backward
    take the kernels' plain versions. device="cuda" without a card raises;
    the step refuses a batch on another device."""
    dev = resolve_device(device)
    schedule = step_exp_lr(cfg)
    params = [p for p in simulator.parameters()]
    lay = _sp_layout(cfg, sp)
    if lay is not None:      # the grid decides whether the batch is cut
        dp = lay.dp > 1
    ranks = dp or sp
    n_ranks = dp_mod.require_group() if ranks else 1
    reduce = dp_mod.all_reduce_sum if ranks else None

    def loss_and_grads(norm_state, dyn, static, accumulate):
        out = forward_batch_block(simulator, norm_state, dyn, static, cfg,
                                  accumulate_normalizer=accumulate,
                                  norm_reduce=reduce)
        loss = training_loss(out, cfg)
        with span("gfvgn.train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads, out

    def grads_and_outputs(state: TrainState, dyn, static):
        b = dyn.uvp.shape[0]
        # under dp the rank's rows are one device block of the global batch
        order = microbatch_order(b, cfg.microbatch,
                                 1 if dp else max(cfg.dp_devices, 1))
        if order is None:
            loss, grads, out = loss_and_grads(state.norm_state, dyn, static,
                                              True)
            return loss, grads, out.norm_state, out
        order = order.to(dyn.uvp.device)
        n_k = order.shape[0]
        norm_state = state.norm_state
        if cfg.norm_global:
            # the whole batch's accumulation, once, before any chunk
            n_pad = dyn.uvp.shape[1]
            theta_nodes = dyn.theta[:, None, :].expand(
                b, n_pad, dyn.theta.shape[-1])
            mask_b = static.node_mask[None].expand(b, n_pad)
            _, norm_state = norm_mod.normalize(
                norm_state, theta_nodes, mask_b,
                max_accumulations=float(cfg.dataset_size), accumulate=True,
                reduce=reduce)
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
        with span("gfvgn.train.step", step=state.step):
            with torch.enable_grad(), (sp_mod.sp_context(lay) if sp
                                       else contextlib.nullcontext()):
                loss, grads, norm_state, out = grads_and_outputs(state, dyn,
                                                                 static)
            uvp_new = out.uvp_node_new.detach()
            if ranks:
                grads = dp_mod.all_reduce_grads(grads, 1.0 / n_ranks)
            lr = schedule(state.epoch)
            apply_update(state, params, grads, lr)
            state.norm_state = norm_state
            state.step += 1
            return (state, step_metrics(
                loss, out, grads, lr,
                mean=dp_mod.all_reduce_mean if ranks else None), uvp_new)
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
    so a group launches the kernels a train step launches.

    With `dp`, every group is padded to a multiple of dp_devices
    (`mixed_block_batches(n_dev=...)`) and each rank runs its block of
    every group's rows; the group sums, the summed gradients (scale 1: the
    weights are already 1/batch_size) and the summed metrics are
    all-reduced, and every group's new states are gathered for the
    payback (the module's docstring). With `sp`, `statics` are the rank's
    cuts, each group's DynamicPack is cut to the rank's node rows here,
    and the gradients and metrics, which every rank of an sp group holds
    sp_devices-fold, take the scale 1/sp_devices."""

    def __init__(self, cfg: Config, simulator, device="cuda",
                 dp: bool = False, sp: bool = False):
        self.cfg = cfg
        self.lay = _sp_layout(cfg, sp)
        self.dp = dp if self.lay is None else self.lay.dp > 1
        self.ranks = self.dp or sp
        if self.ranks:
            dp_mod.require_group()
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
            with span("gfvgn.train.backward"):
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
        gsum = acc["gsum"]
        parts = [acc["loss"], acc["cont"], acc["mom"], acc["press"]]
        if self.ranks:
            scale = 1.0 / (self.lay.sp if self.lay is not None else 1)
            gsum = dp_mod.all_reduce_grads(gsum, scale)
            parts = list(dp_mod.all_reduce_sum(torch.stack(parts)) * scale)
        lr = self.schedule(state.epoch)
        apply_update(state, self.params, gsum, lr)
        state.norm_state = norm_state
        state.step += 1
        return state, StepMetrics(*parts, grad_norm=global_norm(gsum), lr=lr)

    def run_batch(self, state: TrainState, batch, gather, statics,
                  payback=None):
        """One step on `batch` (an element of `mixed_block_batches`: [(ci,
        idxs, weights, n_real), ...]); `gather(idxs)` gives a group's
        DynamicPack and `payback(idxs, uvp)`, where given, takes each
        group's real rows (with `dp`: gathered from every rank). Returns
        (state, metrics)."""
        with span("gfvgn.train.step", step=state.step):
            return self._run_batch(state, batch, gather, statics, payback)

    def _run_batch(self, state, batch, gather, statics, payback):
        lay = self.lay
        if self.dp:       # this rank's rows of each group
            at = (dict(process_id=lay.dp_index, process_count=lay.dp)
                  if lay is not None else {})
            mine = [(dp_mod.local_rows(idxs, len(idxs), **at),
                     dp_mod.local_rows(w, len(idxs), **at))
                    for _, idxs, w, _ in batch]
        else:
            mine = [(idxs, w) for _, idxs, w, _ in batch]
        if lay is not None:     # and of each group its node rows
            gather_all = gather
            gather = lambda ix: sp_mod.local_rows_sp(gather_all(ix), lay)
        weights = [to_device(w, self.dev) for _, w in mine]
        norm_state = state.norm_state
        if self.cfg.norm_global:
            sums = self.init_sums()
            for (ci, _, _, _), (idxs, _), w in zip(batch, mine, weights):
                sums = self.group_stats(sums, gather(idxs), statics[ci], w)
            sums = norm_mod.reduce_sums(
                sums, dp_mod.all_reduce_sum if self.ranks else None)
            norm_state = self.norm_update(norm_state, sums)
        acc = self.init_acc()
        with (sp_mod.sp_context(lay) if lay is not None
              else contextlib.nullcontext()):
            for (ci, idxs, _, g), (mine_idxs, _), w in zip(batch, mine,
                                                           weights):
                acc, uvp_new = self.group_grads(norm_state, acc,
                                                gather(mine_idxs),
                                                statics[ci], w)
                if payback is not None:
                    if lay is not None:
                        uvp_new = sp_mod.gather_states(uvp_new, len(idxs),
                                                       lay)
                    elif self.dp:
                        uvp_new = dp_mod.all_gather_rows(uvp_new, len(idxs))
                    payback(idxs[:g], uvp_new[:g])
        return self.apply_update(state, acc, norm_state)
