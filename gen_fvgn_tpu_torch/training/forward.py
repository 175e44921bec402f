"""Shared pieces of the forward pass.

Counterpart of `gen_fvgn_tpu/training/forward.py`, cut to what the block
engine's rollout and training use: `ForwardOutputs`, the hard Dirichlet
overwrite and `training_loss`. The segment-engine `forward_batch` and the
weighted loss of the mixed-case step belong to later slices.
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


def training_loss(outputs: ForwardOutputs, cfg: Config) -> torch.Tensor:
    """mean(log(w_p·press + w_c·cont + w_m·(mom_x + mom_y))) over the batch,
    each sample's weighted residual floored at `cfg.loss_log_floor` (at
    least 1e-30) inside the log."""
    loss_batch = (cfg.loss_press * outputs.loss_press
                  + cfg.loss_cont * outputs.loss_cont
                  + cfg.loss_mom * outputs.loss_mom_x
                  + cfg.loss_mom * outputs.loss_mom_y)
    floor = max(cfg.loss_log_floor, 1e-30)
    return torch.log(torch.clamp(loss_batch, min=floor)).mean()
