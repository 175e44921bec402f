"""Shared pieces of the forward pass.

Counterpart of `gen_fvgn_tpu/training/forward.py`, cut to what the block
engine's rollout, training and solves use: `ForwardOutputs`, the hard
Dirichlet overwrite, `training_loss` and its per-sample-weighted form
`training_loss_weighted` (the chunked solves). The segment-engine
`forward_batch` belongs to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
from gen_fvgn_tpu_torch.utils.types import NodeType


class ForwardOutputs(NamedTuple):
    loss_cont: torch.Tensor      # [B, 1]
    loss_mom_x: torch.Tensor     # [B, 1]
    loss_mom_y: torch.Tensor     # [B, 1]
    loss_press: torch.Tensor     # [B, 1]
    uvp_node_new: torch.Tensor   # [B, Np, 3] dimensional
    uvp_cell_new: torch.Tensor   # [B, Nc, 3] dimensional
    norm_state: NormalizerState


def enforce_boundary_conditions(uvp: torch.Tensor, node_type: torch.Tensor,
                                target_uv: torch.Tensor) -> torch.Tensor:
    """Hard Dirichlet overwrite: uv ← y on WALL/INFLOW/PRESS_POINT/IN_WALL
    nodes, p ← 0 at PRESS_POINT. node_type [Np] broadcasts against
    batch-major uvp [B, Np, 3]."""
    dirichlet = ((node_type == int(NodeType.WALL_BOUNDARY)) |
                 (node_type == int(NodeType.INFLOW)) |
                 (node_type == int(NodeType.PRESS_POINT)) |
                 (node_type == int(NodeType.IN_WALL)))[..., None]
    press_pt = (node_type == int(NodeType.PRESS_POINT))[..., None]
    dt = torch.promote_types(uvp.dtype, target_uv.dtype)
    uvp = uvp.to(dt)
    uv = torch.where(dirichlet, target_uv.to(dt), uvp[..., 0:2])
    p = torch.where(press_pt, torch.zeros_like(uvp[..., 2:3]), uvp[..., 2:3])
    return torch.cat([uv, p], dim=-1)


def _log_loss(outputs: ForwardOutputs, cfg: Config) -> torch.Tensor:
    """log(w_p·press + w_c·cont + w_m·(mom_x + mom_y)) per sample, each
    sample's weighted residual floored at `cfg.loss_log_floor` (at least
    1e-30) inside the log."""
    loss_batch = (cfg.loss_press * outputs.loss_press
                  + cfg.loss_cont * outputs.loss_cont
                  + cfg.loss_mom * outputs.loss_mom_x
                  + cfg.loss_mom * outputs.loss_mom_y)
    floor = max(cfg.loss_log_floor, 1e-30)
    return torch.log(torch.clamp(loss_batch, min=floor))


def training_loss(outputs: ForwardOutputs, cfg: Config) -> torch.Tensor:
    """The per-sample log loss (`_log_loss`) averaged over the batch."""
    return _log_loss(outputs, cfg).mean()


def training_loss_weighted(outputs: ForwardOutputs, cfg: Config,
                           weights: torch.Tensor) -> torch.Tensor:
    """Σ_b w_b · log(loss_b), the per-sample-weighted form of
    `training_loss`: with w_b = 1/B on real rows and 0 on padded rows, its
    sum over a batch's chunks is the batch-mean log loss over the real
    rows."""
    logp = _log_loss(outputs, cfg)
    return torch.sum(weights.reshape(logp.shape) * logp)
