"""The finite-volume residual of one graph in plain PyTorch.

The scheme of Gen-FVGN's `FVscheme.py` (conserved form), as the float64
transcription `tests/reference_oracle.py` writes it: one WLSQ gradient
of seven channels [u, v, p new; u, v mixed; u, v old], second-order
interpolation to cells (mean of the corners' Taylor extrapolations) and
to faces (mean of the two ends'), fluxes pinned on inflow and wall faces,
per-cell continuity and momentum residuals pooled as root sums of squares,
the traction balance on outflow faces, and the cell values smoothed back
to the nodes by inverse-distance weights.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.mesh import INFLOW, OUTFLOW, WALL


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero derivative at 0 (a residual that is identically
    zero, as the pressure outlet's on a mesh without outlets)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _sum_to(src, index, n):
    return src.new_zeros((n,) + src.shape[1:]).index_add(0, index, src)


def residual(st: Dict[str, torch.Tensor], uvp_new, uv_hat, uv_old, env):
    """st: the statics of `mesh.statics` as tensors; uvp_new [N, 3],
    uv_hat, uv_old [N, 2] dimensionless; env: theta [9], target_uv [N, 2],
    sigma [3], dt. Returns (losses dict of scalars, rt_uvp [N, 3],
    uvp_cell [C, 3])."""
    n, c = st["pos"].shape[0], st["centroid"].shape[0]
    pos, fn = st["pos"], st["face_node"]
    sn, sf, sc = st["slot_node"], st["slot_face"], st["slot_cell"]
    coll = torch.cat([uvp_new, uv_hat, uv_old], -1)              # [N, 7]

    dphi = coll[st["st_out"]] - coll[st["st_in"]]
    grad = _sum_to(dphi[:, :, None] * st["st_w"][:, None, :],
                   st["st_in"], n)                               # [N, 7, 2]

    th = env["theta"]
    area = st["cells_area"][:, None]
    svec = st["slot_unv"] * st["face_area"][sf][:, None]         # [S, 2]

    r_cell = st["centroid"][sc] - pos[sn]
    corner = coll[sn] + torch.einsum("sd,scd->sc", r_cell, grad[sn])
    cnt = _sum_to(torch.ones_like(corner[:, :1]), sc, c)
    phi_cell = _sum_to(corner, sc, c) / cnt.clamp(min=1.0)      # [C, 7]

    ends = torch.cat([fn[0], fn[1]])
    fc2 = torch.cat([st["face_center"], st["face_center"]])
    two = coll[ends, 0:5] + torch.einsum(
        "sd,scd->sc", fc2 - pos[ends], grad[ends, 0:5])
    e = fn.shape[1]
    phi_face = 0.5 * (two[:e] + two[e:])                        # [E, 5]
    grad_face = 0.5 * (grad[fn[0], 0:5] + grad[fn[1], 0:5])     # [E, 5, 2]

    y_face = 0.5 * (env["target_uv"][fn[0]] + env["target_uv"][fn[1]])
    inflow = (st["face_type"] == INFLOW)[:, None]
    wall = (st["face_type"] == WALL)[:, None]

    def pin(uv):
        uv = torch.where(inflow, y_face, uv)
        return torch.where(wall, torch.zeros_like(uv), uv)

    uv_face = pin(phi_face[:, 0:2])
    uv_face_hat = pin(phi_face[:, 3:5])
    p_face = phi_face[:, 2:3]
    uvp_cell = phi_cell[:, 0:3]

    out_slot = (st["face_type"][sf] == OUTFLOW)[:, None]
    visc = th[4] * torch.einsum("scd,sd->sc", grad_face[sf, 0:2], svec)
    resid = (visc - p_face[sf] * svec) * out_slot
    loss_press = safe_sqrt((resid ** 2).sum())

    unsteady = (uvp_cell[:, 0:2] - phi_cell[:, 5:7]) / env["dt"] * area
    div = _sum_to((uv_face[sf] * svec).sum(-1, keepdim=True), sc, c)
    loss_cont = safe_sqrt((div ** 2).sum()) * th[1]

    uu = uv_face_hat[:, :, None] * uv_face_hat[:, None, :]
    eye = torch.eye(2, dtype=uu.dtype, device=uu.device)
    flux = uu[sf] * th[2] + eye * (p_face[sf][:, :, None] * th[3]) \
        - grad_face[sf, 3:5] * th[4]
    j = torch.einsum("scd,sd->sc", flux, svec)
    mom = th[0] * unsteady + _sum_to(j, sc, c) - th[5] * area
    loss_mom = safe_sqrt((mom ** 2).sum(0)) * env["sigma"][0:2]

    r_node = pos[sn] - st["centroid"][sc]
    w = 1.0 / torch.linalg.vector_norm(r_node, dim=-1, keepdim=True)
    rt = _sum_to(uvp_cell[sc] * w, sn, n) / _sum_to(w, sn, n)
    return ({"cont": loss_cont, "mom_x": loss_mom[0], "mom_y": loss_mom[1],
             "press": loss_press}, rt, uvp_cell)
