"""Rollout / evaluation on the block engine.

Counterpart of `gen_fvgn_tpu/solve/rollout_block.py`. Every step runs under
`torch.no_grad()`; states stay on the device between steps and only the
per-step records are copied to the host.

Spatial parallelism (`sp=True`; JAX `scripts/solve.py:113-134`): `dyn`
and `static` are the rank's node rows and cut statics
(`parallel/sp.py`), every step runs in `parallel.sp.sp_context`, and the
records hold the whole mesh's states, gathered over the sp group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.parallel import sp as sp_mod
from gen_fvgn_tpu_torch.solve.rollout import march
from gen_fvgn_tpu_torch.training.forward import ForwardOutputs
from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState


def _dyn_rows(dyn: DynamicPack, rows: torch.Tensor) -> DynamicPack:
    return DynamicPack(**{
        f.name: getattr(dyn, f.name).index_select(0, rows)
        for f in dataclasses.fields(DynamicPack)})


def make_eval_step_block(cfg: Config, simulator) -> Callable:
    """Forward-only eval step (normalizer not accumulated). Batches above
    cfg.microbatch run as sequential chunks of that size; a batch that does
    not divide is padded with copies of row 0 and the outputs sliced back —
    exact, because samples are independent."""
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
    sp: bool = False,
) -> List[dict]:
    """n_steps autoregressive steps; returns one record per step with the
    per-sample residuals and the new node/cell states as NumPy arrays.
    With `sp`, `dyn` and `static` are the rank's rows of the current sp
    layout (the module's docstring)."""
    step_fn = make_eval_step_block(cfg, simulator)
    if not sp:
        return march(lambda d: step_fn(norm_state, d, static), dyn, n_steps,
                     export_fn, wave_source_fn)
    lay = sp_mod.layout()

    def step(d):
        with sp_mod.sp_context(lay):
            return step_fn(norm_state, d, static)

    src = None
    if wave_source_fn is not None:
        def src(t):       # the rank's nodes of the whole mesh's signal
            sig = torch.as_tensor(wave_source_fn(t))
            lo, hi = sp_mod.entity_rows(sig.shape[-1], lay.sp, lay.sp_index)
            return sig[..., lo:hi]
    return march(step, dyn, n_steps, export_fn, src,
                 whole=lambda t: sp_mod.all_gather_rows_sp(t, lay))


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
