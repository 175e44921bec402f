"""Least-squares finite-difference (LSFD) residual: the pointwise
strong-form alternative to the FV surface-integral loss.

Counterpart of `gen_fvgn_tpu/fv/lsfd.py`, batch-major. The Navier-Stokes
residual is evaluated at interior nodes from the WLSQ gradients and
Hessians,

    r_u = (u·∇)u + ∇p − ν ∇²u,    r_cont = ∇·u,

with loss = ‖r_u‖ + ‖r_v‖ + 10‖r_cont‖ per sample, normalized by the
residual of the first call: that normalization is explicit state (pass the
raw residual of the first call back as `init_residual`).

`lsfd_residual` runs on the segment engine's MeshSample (the runtime WLSQ
of `ops/wlsq.py::node_based_wlsq_precomputed`); `lsfd_residual_block` on a
block StaticPack built with the full folded WLSQ rows
(`wlsq_rows="full"`, cfg.wlsq_block_rows), one sparse apply for every
derivative. Both need order "2nd" or higher (the Hessian columns 2:4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop
from gen_fvgn_tpu_torch.ops.wlsq import node_based_wlsq_precomputed
from gen_fvgn_tpu_torch.utils.types import NodeType


def _interior(node_type: torch.Tensor, node_mask: torch.Tensor,
              dtype) -> torch.Tensor:
    """1.0 at real nodes whose velocity is not pinned, [..., Np, 1]."""
    pinned = ((node_type == int(NodeType.WALL_BOUNDARY))
              | (node_type == int(NodeType.INFLOW))
              | (node_type == int(NodeType.PRESS_POINT))
              | (node_type == int(NodeType.IN_WALL)))
    return (~pinned & node_mask)[..., None].to(dtype)


def _residual(d, u, v, nu, interior, init_residual):
    """(normalized, raw) [B] from the derivatives d(q, c) [B, Np, 1] of the
    fields c = 0 (p), 1 (u), 2 (v) in derivative row q."""
    p_x, p_y = d(0, 0), d(1, 0)
    u_x, u_y, u_xx, u_yy = d(0, 1), d(1, 1), d(2, 1), d(3, 1)
    v_x, v_y, v_xx, v_yy = d(0, 2), d(1, 2), d(2, 2), d(3, 2)
    r_u = ((u * u_x + v * u_y) + p_x - nu * (u_xx + u_yy)) * interior
    r_v = ((u * v_x + v * v_y) + p_y - nu * (v_xx + v_yy)) * interior
    r_c = (u_x + v_y) * interior
    norm = lambda r: torch.sqrt(torch.sum(r ** 2, dim=(1, 2)))     # [B]
    raw = norm(r_u) + norm(r_v) + 10.0 * norm(r_c)
    denom = raw if init_residual is None else init_residual
    return raw / torch.clamp(denom, min=1e-30), raw


def lsfd_residual(
    uvp_new: torch.Tensor,    # [B, Np, 3]
    uv_hat: torch.Tensor,     # [B, Np, 2]
    sample,                   # MeshSample, stacked [B, ...] tensors
    order: str = "2nd",
    init_residual: Optional[torch.Tensor] = None,   # [B], None first call
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalized residual [B], raw residual [B]) on the segment engine."""
    if order == "1st":
        raise ValueError("LSFD needs order >= 2nd (Hessian terms)")
    fields = torch.cat([uvp_new[..., 2:3], uv_hat], dim=-1)      # [p, u, v]
    nabla = node_based_wlsq_precomputed(
        fields, sample.stencil, sample.wlsq_S, sample.wlsq_B, order,
        colscale=sample.wlsq_scale,
        stencil_mask=sample.stencil_mask)                        # [B,Np,3,k]
    d = lambda q, c: nabla[:, :, c, q:q + 1]
    nu = sample.theta[:, 4][:, None, None]
    interior = _interior(sample.node_type, sample.node_mask, uvp_new.dtype)
    return _residual(d, uv_hat[..., 0:1], uv_hat[..., 1:2], nu, interior,
                     init_residual)


def lsfd_residual_block(
    uvp_new: torch.Tensor,    # [B, Np, 3] (or [Np, 3] for one sample)
    uv_hat: torch.Tensor,     # [B, Np, 2]
    dyn,                      # DynamicPack, stacked [B, ...] (or one sample)
    static,                   # StaticPack built with wlsq_rows="full"
    order: str = "2nd",
    init_residual: Optional[torch.Tensor] = None,   # [B], None first call
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalized [B], raw [B]) on the block engine: the gradients and
    Hessians of p, u, v from ONE apply of the folded WLSQ operator with all
    k rows. One sample ([Np, 3], theta [9]) gives scalars."""
    if order == "1st":
        raise ValueError("LSFD needs order >= 2nd (Hessian terms)")
    n_q = static.ops.wlsq_n_q
    if n_q < 4:
        raise ValueError(
            "LSFD on the block engine needs the full folded WLSQ rows "
            "(Hessians): build the pool/static pack with "
            "wlsq_block_rows='full'")
    if uvp_new.ndim == 2:
        norm_r, raw = lsfd_residual_block(
            uvp_new[None], uv_hat[None], dyn.replace(theta=dyn.theta[None]),
            static, order=order, init_residual=init_residual)
        return norm_r[0], raw[0]

    b, n_pad, _ = uvp_new.shape
    fields = torch.cat([uvp_new[..., 2:3], uv_hat], dim=-1)      # p, u, v
    nab = apply_linop(static.ops.wlsq, fields)[:, : n_pad * n_q] \
        .reshape(b, n_pad, n_q, 3)
    d = lambda q, c: nab[:, :, q, c:c + 1]
    nu = dyn.theta[:, 4][:, None, None]
    interior = _interior(static.node_type, static.node_mask,
                         uvp_new.dtype)[None]
    return _residual(d, uv_hat[..., 0:1], uv_hat[..., 1:2], nu, interior,
                     init_residual)
