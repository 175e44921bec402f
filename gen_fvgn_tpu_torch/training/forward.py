"""The trainable forward pass of the segment engine, and the pieces every
engine shares.

Counterpart of `gen_fvgn_tpu/training/forward.py`: `ForwardOutputs`, the
hard Dirichlet overwrite, `relative_edge_features`, `forward_batch`
(normalization → backbone → BC enforcement → time mixing → FV residual →
re-dimensionalization over a stacked [B, ...] MeshSample, the batch axis
written out where the JAX function vmaps; the batch's kernel lists,
`ops.mesh_lists`, built once where the caller gives none and handed to
the backbone and the residual), `training_loss` and its
per-sample-weighted form `training_loss_weighted` (the chunked solves).
The block engine's forward is training/forward_block.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gen_fvgn_tpu_torch import ops
from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.fv.integrator import integrate_residuals
from gen_fvgn_tpu_torch.ops.segment import gather_rows, masked_mean_var
from gen_fvgn_tpu_torch.training import normalizer as norm_mod
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
from gen_fvgn_tpu_torch.utils.spans import span
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


def relative_edge_features(x: torch.Tensor, pos: torch.Tensor,
                           face_node: torch.Tensor) -> torch.Tensor:
    """Edge features (x_s − x_r) ⊕ (pos_s − pos_r) ⊕ ‖pos_s − pos_r‖:
    x [B, N, F], pos [B, N, 2], face_node [B, 2, E] -> [B, E, F + 3]."""
    s, r = face_node[:, 0], face_node[:, 1]
    dx = gather_rows(x, s) - gather_rows(x, r)
    dp = gather_rows(pos, s) - gather_rows(pos, r)
    return torch.cat(
        [dx, dp, torch.linalg.vector_norm(dp, dim=-1, keepdim=True)], dim=-1)


def forward_batch(
    simulator,                     # nn.Module of models/simulator.py
    norm_state: NormalizerState,
    batch,                         # MeshSample, stacked [B, ...] tensors
    cfg: Config,
    accumulate_normalizer: bool = True,
    norm_reduce=None,
    lists: Optional[ops.MeshLists] = None,
) -> ForwardOutputs:
    """`lists`: the batch's `ops.mesh_lists(batch, cfg)`, built here where
    not given (None again for CPU tensors and inside
    `ops.plain_versions()`: the plain versions)."""
    if lists is None:
        lists = ops.mesh_lists(batch, cfg)
    b = batch.uvp.shape[0]
    theta_nodes = batch.theta[:, None, :].expand(
        batch.uvp.shape[:2] + (batch.theta.shape[-1],))
    x = torch.cat([batch.uvp, theta_nodes], dim=-1)              # [B,Np,12]

    uv_old = batch.uvp[..., 0:2] / batch.uvp_dim[:, None, 0:2]   # [B,Np,2]

    # per-graph standardization of the uvp channels (norm_uvp)
    phi = x[..., : cfg.node_phi_size]
    if cfg.norm_uvp:
        mean, var = masked_mean_var(phi, batch.node_mask, axis=1)
        phi = (phi - mean) / (torch.sqrt(var) + 1e-8)

    # running global normalizer on the θ channels (norm_global)
    theta_ch = x[..., cfg.node_phi_size:]
    if cfg.norm_global:
        theta_ch, norm_state = norm_mod.normalize(
            norm_state, theta_ch, batch.node_mask,
            max_accumulations=float(cfg.dataset_size),
            accumulate=accumulate_normalizer, reduce=norm_reduce)
    x = torch.cat([phi, theta_ch], dim=-1)

    edge_attr = relative_edge_features(x, batch.pos, batch.face_node)
    uvp_new = simulator(x, edge_attr, batch.face_node, batch.node_mask,
                        batch.face_mask,
                        None if lists is None else lists.inc)   # [B,Np,3]

    # soft clamp in the backbone's output type, then the hard Dirichlet
    # overwrite (which promotes to float32)
    uvp_new = torch.tanh(uvp_new / 10.0) * 10.0
    uvp_new = enforce_boundary_conditions(uvp_new, batch.node_type,
                                          batch.target_uv)

    if cfg.integrator == "explicit":
        uv_hat = uv_old
    elif cfg.integrator == "implicit":
        uv_hat = uvp_new[..., 0:2]
    elif cfg.integrator == "imex":
        uv_hat = 0.5 * (uv_old + uvp_new[..., 0:2])
    else:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")

    with span("gfvgn.fv.residual"):
        losses, rt_uvp, uvp_cell = integrate_residuals(
            uvp_new, uv_hat, uv_old, batch, order=cfg.order,
            conserved_form=cfg.conserved_form, ncn_smooth=cfg.ncn_smooth,
            fv_lists=None if lists is None else lists.fv)
    rt_uvp = enforce_boundary_conditions(rt_uvp, batch.node_type,
                                         batch.target_uv)

    # re-dimensionalize for pool storage
    scale_node = (batch.uvp_dim * batch.sigma)[:, None, :]
    return ForwardOutputs(
        loss_cont=losses.cont.reshape(b, 1),
        loss_mom_x=losses.mom_x.reshape(b, 1),
        loss_mom_y=losses.mom_y.reshape(b, 1),
        loss_press=losses.press.reshape(b, 1),
        uvp_node_new=rt_uvp * scale_node,
        uvp_cell_new=uvp_cell * scale_node,
        norm_state=norm_state,
    )


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
