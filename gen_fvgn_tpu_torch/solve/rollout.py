"""Rollout inference on the segment engine: time marching by network
evaluation alone.

Counterpart of `gen_fvgn_tpu/solve/rollout.py` (`make_eval_step`,
`rollout`): a fixed batch of environments is advanced by evaluating the
trained network again and again (no optimizer), each step's new state fed
back as the next input; the FV residuals are diagnostics only. Every step
runs under `torch.no_grad()`; states stay on the device between steps and
only the per-step records are copied to the host. A request's topology
never changes, so `rollout` builds the batch's kernel lists
(`ops.mesh_lists`) once and every step runs on them. `march` is the time
loop both engines' rollouts share.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from gen_fvgn_tpu_torch import ops
from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.training.forward import ForwardOutputs, forward_batch
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
from gen_fvgn_tpu_torch.utils import spans


def make_eval_step(cfg: Config, simulator) -> Callable:
    """(norm_state, batch, lists=None) -> ForwardOutputs without gradients
    or normalizer accumulation, on the whole stacked MeshSample batch;
    `lists`, the batch's `ops.mesh_lists`, are built by the step where not
    given."""
    def step(norm_state: NormalizerState, batch,
             lists: Optional[ops.MeshLists] = None) -> ForwardOutputs:
        with torch.no_grad():
            return forward_batch(simulator, norm_state, batch, cfg,
                                 accumulate_normalizer=False, lists=lists)
    return step


def march(step_fn: Callable, data, n_steps: int,
          export_fn: Optional[Callable] = None,
          wave_source_fn: Optional[Callable] = None,
          whole: Optional[Callable] = None) -> List[dict]:
    """n_steps autoregressive steps of step_fn(data) -> ForwardOutputs on
    `data` (any batch with a `uvp` field and `replace`); before each step
    the wave source of time index t + 1 is added to the p channel where
    `wave_source_fn` is given. Returns one record per step with the
    per-sample residuals and the new node/cell states as NumPy arrays;
    `whole` (spatial parallelism: the gather of every rank's rows) maps
    each state to the one recorded."""
    whole = whole or (lambda t: t)
    host = lambda a: a.detach().to("cpu", torch.float32).numpy()
    history = []
    with spans.span("gfvgn.rollout.request", steps=n_steps):
        for t in range(n_steps):
            if wave_source_fn is not None:
                sig = torch.as_tensor(wave_source_fn(t + 1),  # time index >= 1
                                      dtype=data.uvp.dtype,
                                      device=data.uvp.device)
                uvp = data.uvp.clone()
                uvp[..., 2] += sig
                data = data.replace(uvp=uvp)
            with spans.span("gfvgn.rollout.step", t=t):
                out = step_fn(data)
            with spans.span("gfvgn.rollout.record", t=t):
                rec = {
                    "step": t,
                    "loss_cont": host(out.loss_cont).reshape(-1),
                    "loss_mom_x": host(out.loss_mom_x).reshape(-1),
                    "loss_mom_y": host(out.loss_mom_y).reshape(-1),
                    "loss_press": host(out.loss_press).reshape(-1),
                    "uvp_node": host(whole(out.uvp_node_new)),
                    "uvp_cell": host(whole(out.uvp_cell_new)),
                }
                if spans.enabled():
                    spans.note(bytes=sum(a.nbytes for a in rec.values()
                                         if hasattr(a, "nbytes")))
            history.append(rec)
            if export_fn is not None:
                with spans.span("gfvgn.rollout.export", t=t):
                    export_fn(t, rec["uvp_node"], rec["uvp_cell"], rec)
            data = data.replace(uvp=out.uvp_node_new)
    return history


def rollout(
    cfg: Config,
    simulator,
    norm_state: NormalizerState,
    batch,                                      # stacked MeshSample [B, ...]
    n_steps: int,
    export_fn: Optional[Callable] = None,       # (step, uvp_node, uvp_cell, rec)
    wave_source_fn: Optional[Callable] = None,  # t -> [B, Np] p-source signal
) -> List[dict]:
    """n_steps autoregressive steps of the segment engine, all on the
    batch's kernel lists, built once; the final state is in the last
    record's "uvp_node"."""
    step_fn = make_eval_step(cfg, simulator)
    lists = ops.mesh_lists(batch, cfg)
    return march(lambda b: step_fn(norm_state, b, lists), batch, n_steps,
                 export_fn, wave_source_fn)
