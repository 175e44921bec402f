"""Differentiable finite-volume residual assembly (the PDE loss) of the
segment engine.

Counterpart of `gen_fvgn_tpu/fv/integrator.py` (`FVLosses`,
`_fix_face_flux_bc`, `_graph_sqnorm_pool`, `_pressure_outlet_loss`,
`integrate_residuals`), on batch-major tensors: the JAX function assembles
one padded mesh under a vmap; here every array carries the batch axis
([B, ...], index arrays per sample) and each per-graph pooling is a masked
reduction over the sample's rows. The pressure-outlet loss is total by a
zero-gradient sqrt, as in JAX.

Given the batch's FV lists (`fv_lists`, of `ops.mesh_lists`, which builds
them on CUDA tensors outside `ops.plain_versions()` at the forms they
cover: order "2nd", the conserved form, `ncn_smooth` either way, the
Config's defaults) the residual runs on `ops/fv_csr.py`'s list passes;
without them it takes the plain path below. `FV_KERNEL_CALLS` and
`FV_PLAIN_CALLS` count the calls by path.

θ_PDE layout: [unsteady, continuity, convection, grad_p/ρ, diffusion,
source/U, U_in_x, U_in_y, Re].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gen_fvgn_tpu_torch.ops import fv_csr, interp
from gen_fvgn_tpu_torch.ops.segment import (gather_rows, safe_sqrt,
                                            segment_sum)
from gen_fvgn_tpu_torch.ops.wlsq import node_based_wlsq_precomputed
from gen_fvgn_tpu_torch.utils.types import NodeType

# integrate_residuals calls by path, incremented once a call
FV_KERNEL_CALLS = 0
FV_PLAIN_CALLS = 0


class FVLosses(NamedTuple):
    cont: torch.Tensor     # [B]
    mom_x: torch.Tensor    # [B]
    mom_y: torch.Tensor    # [B]
    press: torch.Tensor    # [B]


def _coef(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-sample scalars [B] shaped to broadcast against [B, ...] arrays of
    `ndim` dimensions."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _fix_face_flux_bc(face_uv: torch.Tensor, sample) -> torch.Tensor:
    """Pin inflow-face flux to the Dirichlet target mean and wall-face flux
    to zero."""
    y_face = 0.5 * (gather_rows(sample.target_uv, sample.face_node[:, 0]) +
                    gather_rows(sample.target_uv, sample.face_node[:, 1]))
    is_inflow = (sample.face_type == int(NodeType.INFLOW))[..., None]
    is_wall = (sample.face_type == int(NodeType.WALL_BOUNDARY))[..., None]
    out = torch.where(is_inflow, y_face, face_uv)
    return torch.where(is_wall, torch.zeros_like(out), out)


def _graph_sqnorm_pool(per_cell: torch.Tensor,
                       cell_mask: torch.Tensor) -> torch.Tensor:
    """sqrt(Σ_cells value²) per sample and channel over the (masked)
    cells: [B, Nc, C] -> [B, C]."""
    m = cell_mask.to(per_cell.dtype)[..., None]
    return safe_sqrt(torch.sum((per_cell ** 2) * m, dim=1))


def _pressure_outlet_loss(p_face, nabla_uv_face, sample, diffusion_coef,
                          surface_vec) -> torch.Tensor:
    """Traction balance on OUTFLOW faces: ‖μ∇u·S − pS‖ pooled over each
    graph, [B]."""
    cf = sample.cells_face
    slot_outflow = (gather_rows(sample.face_type, cf)
                    == int(NodeType.OUTFLOW)) & sample.slot_mask
    visc = _coef(diffusion_coef, 3) * torch.einsum(
        "bscd,bsd->bsc", gather_rows(nabla_uv_face, cf), surface_vec)
    surf_p = gather_rows(p_face, cf) * surface_vec               # [B,Ck,2]
    resid = (visc - surf_p) * slot_outflow.to(visc.dtype)[..., None]
    return safe_sqrt(torch.sum(resid ** 2, dim=(1, 2)))


class FaceValues(NamedTuple):
    """What the cells read of the faces (`face_values`)."""
    uv_new: torch.Tensor        # [B, Ef, 2] boundary-fixed
    p_new: torch.Tensor         # [B, Ef, 1]
    uv_hat: torch.Tensor        # [B, Ef, 2] boundary-fixed
    nabla_uv_new: torch.Tensor  # [B, Ef, 2, 2] ∇u, ∇v (new state)
    nabla_uv_hat: torch.Tensor  # [B, Ef, 2, 2]


def wlsq_gradients(collection: torch.Tensor, sample,
                   order: str) -> torch.Tensor:
    """The 7 channels' WLSQ gradients [B, Np, 7, 2] (the Hessian is
    disabled in the reference's live path)."""
    nabla = node_based_wlsq_precomputed(
        collection, sample.stencil, sample.wlsq_S, sample.wlsq_B, order,
        colscale=sample.wlsq_scale, stencil_mask=sample.stencil_mask)
    return nabla[..., 0:2]


def face_values(collection: torch.Tensor, grad_phi: torch.Tensor,
                sample) -> FaceValues:
    """node→face of the values (Taylor-corrected) and of the gradients of
    channels 0:5, and the boundary fix of the fluxing velocities."""
    phi_face = interp.node_to_face(
        collection[..., 0:5], grad_phi[:, :, 0:5], None,
        sample.face_node, sample.face_center, sample.pos)        # [B,Ef,5]
    nabla_face = interp.node_to_face(
        grad_phi[:, :, 0:5], None, None,
        sample.face_node, sample.face_center, sample.pos)        # [B,Ef,5,2]
    return FaceValues(
        uv_new=_fix_face_flux_bc(phi_face[..., 0:2], sample),
        p_new=phi_face[..., 2:3],
        uv_hat=_fix_face_flux_bc(phi_face[..., 3:5], sample),
        nabla_uv_new=nabla_face[:, :, 0:2],
        nabla_uv_hat=nabla_face[:, :, 3:5])


def cell_residuals(collection: torch.Tensor, grad_phi: torch.Tensor,
                   faces: FaceValues, sample, conserved_form: bool = True
                   ) -> Tuple[FVLosses, torch.Tensor]:
    """node→cell, the flux and volume integrals and the pooled losses:
    (losses [B] each, uvp_cell_new [B, Nc, 3])."""
    n_cells = sample.centroid.shape[1]
    theta = sample.theta                                         # [B, 9]
    unsteady_c, cont_c, conv_c = theta[:, 0], theta[:, 1], theta[:, 2]
    gradp_c, diff_c, source_c = theta[:, 3], theta[:, 4], theta[:, 5]
    cells_area = sample.cells_area[..., None]                    # [B,Nc,1]
    surface_vec = sample.slot_unv * gather_rows(
        sample.face_area, sample.cells_face)[..., None]          # [B,Ck,2]

    phi_cell = interp.node_to_cell(
        collection, grad_phi, None, sample.cells_node,
        sample.cells_index, sample.pos, sample.centroid, n_cells,
        sample.slot_mask)                                        # [B,Nc,7]
    uv_face_new, p_face_new = faces.uv_new, faces.p_new
    uv_face_hat = faces.uv_hat
    nabla_uv_face_hat = faces.nabla_uv_hat

    uvp_cell_new = phi_cell[..., 0:3]
    uv_cell_old = phi_cell[..., 5:7]

    loss_press = _pressure_outlet_loss(
        p_face_new, faces.nabla_uv_new, sample, diff_c, surface_vec)

    unsteady_cell = ((uvp_cell_new[..., 0:2] - uv_cell_old)
                     / _coef(sample.dt, 3)) * cells_area
    cf, ci = sample.cells_face, sample.cells_index

    if conserved_form:
        # continuity: ∮ u·dS per cell
        slot_div = torch.einsum("bsd,bsd->bs", gather_rows(uv_face_new, cf),
                                surface_vec)
        cell_div = segment_sum(slot_div[..., None], ci, n_cells,
                               sample.slot_mask)                 # [B,Nc,1]
        loss_cont = _graph_sqnorm_pool(cell_div, sample.cell_mask) \
            * cont_c[:, None]

        # momentum: unsteady + ∮ (c·u⊗u + pI − ν∇u)·dS − source·A
        uu = uv_face_hat[..., :, None] * uv_face_hat[..., None, :]  # [B,Ef,2,2]
        conv_flux = gather_rows(uu, cf) * _coef(conv_c, 4)
        vis_flux = gather_rows(nabla_uv_face_hat, cf) * _coef(diff_c, 4)
        eye = torch.eye(2, dtype=uu.dtype, device=uu.device)
        p_flux = (eye * gather_rows(p_face_new, cf)[..., None]) \
            * _coef(gradp_c, 4)
        j_flux = torch.einsum("bscd,bsd->bsc",
                              conv_flux + p_flux - vis_flux, surface_vec)
        rhs = segment_sum(j_flux, ci, n_cells, sample.slot_mask) \
            - _coef(source_c, 3) * cells_area
        loss_mom_cell = _coef(unsteady_c, 3) * unsteady_cell + rhs
        loss_mom = _graph_sqnorm_pool(loss_mom_cell, sample.cell_mask) \
            * sample.sigma[:, 0:2]
    else:
        nabla_cell = interp.node_to_cell(
            grad_phi[:, :, 0:5], None, None, sample.cells_node, ci,
            sample.pos, sample.centroid, n_cells,
            sample.slot_mask)                                    # [B,Nc,5,2]
        nabla_uvp_cell = nabla_cell[:, :, 0:3]
        nabla_uv_cell_hat = nabla_cell[:, :, 3:5]
        uv_cell_hat = phi_cell[..., 3:5]

        # continuity from the cell-centred divergence
        cell_div = (nabla_uvp_cell[:, :, 0:1, 0]
                    + nabla_uvp_cell[:, :, 1:2, 1]) * cells_area
        loss_cont = _graph_sqnorm_pool(cell_div, sample.cell_mask) \
            * cont_c[:, None]

        convection_cell = torch.einsum(
            "bncd,bnd->bnc", nabla_uv_cell_hat, uv_cell_hat) * cells_area
        grad_p_cell = nabla_uvp_cell[:, :, 2] * cells_area       # [B,Nc,2]
        visc_slot = torch.einsum("bscd,bsd->bsc",
                                 gather_rows(nabla_uv_face_hat, cf),
                                 surface_vec)
        visc_cell = segment_sum(visc_slot, ci, n_cells, sample.slot_mask)
        loss_mom_cell = (_coef(unsteady_c, 3) * unsteady_cell
                         + _coef(conv_c, 3) * convection_cell
                         + _coef(gradp_c, 3) * grad_p_cell
                         - _coef(diff_c, 3) * visc_cell
                         - _coef(source_c, 3) * cells_area)
        loss_mom = _graph_sqnorm_pool(loss_mom_cell, sample.cell_mask) \
            * sample.sigma[:, 0:2]

    losses = FVLosses(cont=loss_cont[:, 0], mom_x=loss_mom[:, 0],
                      mom_y=loss_mom[:, 1], press=loss_press)
    return losses, uvp_cell_new


def integrate_residuals(
    uvp_new: torch.Tensor,    # [B, Np, 3]
    uv_hat: torch.Tensor,     # [B, Np, 2]
    uv_old: torch.Tensor,     # [B, Np, 2]
    sample,                   # MeshSample, stacked [B, ...] tensors
    order: str = "2nd",
    conserved_form: bool = True,
    ncn_smooth: bool = True,
    fv_lists: Optional[fv_csr.FvLists] = None,
) -> Tuple[FVLosses, torch.Tensor, torch.Tensor]:
    """WLSQ gradient reconstruction + flux/volume integral residual
    assembly. Returns (losses [B] each, rt_uvp_new [B, Np, 3],
    uvp_cell_new [B, Nc, 3]). With `fv_lists` (order "2nd", the conserved
    form) on the list passes of `ops/fv_csr.py`, else on the plain path."""
    global FV_KERNEL_CALLS, FV_PLAIN_CALLS
    if fv_lists is not None:
        if order != "2nd" or not conserved_form:
            raise ValueError(f"the FV lists' passes take order '2nd' in the "
                             f"conserved form, got {order!r}, "
                             f"conserved_form={conserved_form}")
        FV_KERNEL_CALLS += 1
        losses, rt_uvp_new, uvp_cell_new = fv_csr.residual(
            uvp_new, uv_hat, uv_old, sample, ncn_smooth, fv_lists)
        return FVLosses(*losses), rt_uvp_new, uvp_cell_new
    FV_PLAIN_CALLS += 1

    # one 7-channel WLSQ call: [uvp_new(3), uv_hat(2), uv_old(2)]
    collection = torch.cat([uvp_new, uv_hat, uv_old], dim=-1)    # [B,Np,7]
    grad_phi = wlsq_gradients(collection, sample, order)         # [B,Np,7,2]
    faces = face_values(collection, grad_phi, sample)
    losses, uvp_cell_new = cell_residuals(collection, grad_phi, faces,
                                          sample, conserved_form)
    if ncn_smooth:
        rt_uvp_new = interp.cell_to_node(
            uvp_cell_new, None, sample.cells_node, sample.cells_index,
            sample.centroid, sample.pos, sample.pos.shape[1],
            sample.slot_mask)
    else:
        rt_uvp_new = uvp_new
    return losses, rt_uvp_new, uvp_cell_new
