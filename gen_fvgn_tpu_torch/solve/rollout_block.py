"""Rollout / evaluation on the block engine.

Counterpart of `gen_fvgn_tpu/solve/rollout_block.py`. Every step runs under
`torch.no_grad()`; states stay on the device between steps and only the
per-step records are copied to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.solve.rollout import march
from gen_fvgn_tpu_torch.training.forward import ForwardOutputs
from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState


def _dyn_rows(dyn: DynamicPack, rows: torch.Tensor) -> DynamicPack:
    return DynamicPack(**{
        f.name: getattr(dyn, f.name).index_select(0, rows)
        for f in dataclasses.fields(DynamicPack)})


def make_eval_step_block(cfg: Config, simulator,
                         plain_kernels: bool = False) -> Callable:
    """Forward-only eval step (normalizer not accumulated). Batches above
    cfg.microbatch run as sequential chunks of that size; a batch that does
    not divide is padded with copies of row 0 and the outputs sliced back —
    exact, because samples are independent.

    plain_kernels=True runs the step with the kernels' plain PyTorch
    versions on whatever device the data is on. It exists for the
    comparison of a kernel step with a plain step on the card and for the
    tests, and nothing else uses it."""
    def fwd(norm_state, dyn, static):
        return forward_batch_block(simulator, norm_state, dyn, static, cfg,
                                   accumulate_normalizer=False)

    def run(norm_state, dyn, static):
        b = dyn.uvp.shape[0]
        mb = cfg.microbatch
        if not mb or b <= mb:
            return fwd(norm_state, dyn, static)
        rem = (-b) % mb
        rows = torch.arange(b + rem, device=dyn.uvp.device)
        rows = torch.where(rows < b, rows, torch.zeros_like(rows))
        chunks = [fwd(norm_state, _dyn_rows(dyn, rows[k:k + mb]), static)
                  for k in range(0, b + rem, mb)]
        cat = lambda name: torch.cat(
            [getattr(c, name) for c in chunks], dim=0)[:b]
        return ForwardOutputs(
            loss_cont=cat("loss_cont"), loss_mom_x=cat("loss_mom_x"),
            loss_mom_y=cat("loss_mom_y"), loss_press=cat("loss_press"),
            uvp_node_new=cat("uvp_node_new"),
            uvp_cell_new=cat("uvp_cell_new"), norm_state=norm_state)

    def step(norm_state: NormalizerState, dyn: DynamicPack,
             static: StaticPack) -> ForwardOutputs:
        with torch.no_grad():
            if not plain_kernels:
                return run(norm_state, dyn, static)
            from gen_fvgn_tpu_torch.ops import plain_versions
            with plain_versions():
                return run(norm_state, dyn, static)
    return step


def rollout_block(
    cfg: Config,
    simulator,
    norm_state: NormalizerState,
    dyn: DynamicPack,
    static: StaticPack,
    n_steps: int,
    export_fn: Optional[Callable] = None,
    wave_source_fn: Optional[Callable] = None,  # t -> [B, Np] p-source signal
) -> List[dict]:
    """n_steps autoregressive steps; returns one record per step with the
    per-sample residuals and the new node/cell states as NumPy arrays."""
    step_fn = make_eval_step_block(cfg, simulator)
    return march(lambda d: step_fn(norm_state, d, static), dyn, n_steps,
                 export_fn, wave_source_fn)


def rollout_block_scan(cfg: Config, simulator, norm_state: NormalizerState,
                       dyn: DynamicPack, static: StaticPack, n_steps: int):
    """Whole rollout with the state kept on the device: returns the final
    dyn and the per-step residual traces, each [n_steps, B, 1] (no host
    round-trips inside the loop)."""
    step_fn = make_eval_step_block(cfg, simulator)
    traces = []
    for _ in range(n_steps):
        out = step_fn(norm_state, dyn, static)
        dyn = dyn.replace(uvp=out.uvp_node_new)
        traces.append((out.loss_cont, out.loss_mom_x, out.loss_mom_y,
                       out.loss_press))
    return dyn, tuple(torch.stack(t) for t in zip(*traces))
