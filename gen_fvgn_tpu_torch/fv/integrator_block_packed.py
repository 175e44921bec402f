"""Whole-batch finite-volume residual assembly (block engine).

Counterpart of `gen_fvgn_tpu/fv/integrator_block_packed.py`: same
signature, same results ([B, ...] batch-major in and out).

Layout chosen for the card: the FV section runs ONCE for the whole batch on
channel-major packed 2-D arrays

    x_cm [rows, C·B]   column c·B + b = channel c of sample b

the same packing the JAX package uses, for a reason that also holds on a
GPU: each FV operator is then ONE CSR × dense product for the whole batch
(the operator's indices and values are read once, the dense operand is
row-major with C·B contiguous columns per gathered row), and channel slices
are contiguous column ranges. Per-sample coefficients become coefficient
rows [1, C·B]. The only extra work is the pack/unpack transposes at the
section boundary (a few MB of float32).

These applies are float32 and narrow (C·B is not a multiple of 128 at the
batch sizes in use), so they are `torch.sparse` products, not the spmm
kernel — the same split as in the JAX package, whose Pallas kernels only
take 128-lane multiples.

`fv_ell=True` makes the JAX package apply the low-degree FV operators
(n2c, n2f, c2n, flux) through ELL tables (k row-takes and fmas) instead of
its dense tiles: a TPU layout of the same operators, which reads only the
non-zeros. CSR reads only the non-zeros already, so here both settings run
the same CSR products and give the JAX package's losses within float32
summation order.

Under spatial parallelism (`parallel/sp.py`) the section runs on the
rank's node, face and cell rows, and each loss's sum of squares over faces
or cells is summed over the sp group (`sp_sum`) before its square root, so
every rank holds the whole losses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gen_fvgn_tpu_torch.fv.integrator import FVLosses
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop
from gen_fvgn_tpu_torch.ops.segment import safe_sqrt
from gen_fvgn_tpu_torch.parallel.sp import sp_sum


def pack_cm(x: torch.Tensor) -> torch.Tensor:
    """[B, rows, C] -> channel-major [rows, C·B]."""
    b, n, c = x.shape
    return x.permute(1, 2, 0).reshape(n, c * b)


def unpack_cm(x: torch.Tensor, b: int) -> torch.Tensor:
    """[rows, C·B] -> [B, rows, C]."""
    n, cb = x.shape
    return x.reshape(n, cb // b, b).permute(2, 0, 1).contiguous()


def _row(vals_b: torch.Tensor, n_ch: int) -> torch.Tensor:
    """Per-sample values [B] -> coefficient row [1, n_ch·B]
    (value at column c·B + b is vals_b[b])."""
    return vals_b.repeat(n_ch)[None, :]


def _tile_ch(x: torch.Tensor, n_ch: int) -> torch.Tensor:
    """Broadcast one packed channel block [rows, B] across n_ch channels."""
    return x.repeat(1, n_ch)


def integrate_residuals_block_packed(
    uvp_new: torch.Tensor,    # [B, Np, 3] batch-major (model output)
    uv_hat: torch.Tensor,     # [B, Np, 2]
    uv_old: torch.Tensor,     # [B, Np, 2]
    dyn: DynamicPack,         # stacked [B, ...]
    static: StaticPack,
    order: str = "2nd",
    conserved_form: bool = True,
    ncn_smooth: bool = True,
    fv_ell: bool = False,
) -> Tuple[FVLosses, torch.Tensor, torch.Tensor]:
    """Returns (losses [B] each, rt_uvp [B, Np, 3], uvp_cell [B, Nc, 3]).
    `fv_ell` is accepted for the JAX signature and changes nothing here
    (see the module's docstring)."""
    del fv_ell
    ops = static.ops
    b, n_pad, _ = uvp_new.shape
    ap = apply_linop

    # pack the section inputs: [Np, 7B] with channels (u,v,p,uh,vh,uo,vo)
    collection = torch.cat(
        [pack_cm(uvp_new), pack_cm(uv_hat), pack_cm(uv_old)], dim=-1)

    nabla = apply_linop(ops.wlsq, collection)[: n_pad * ops.wlsq_n_q] \
        .reshape(n_pad, ops.wlsq_n_q, 7 * b)
    gx, gy = nabla[:, 0], nabla[:, 1]                  # [Np, 7B]

    theta = dyn.theta                                  # [B, 9]
    cells_area = static.cells_area                     # [Nc, 1]
    dt2 = _row(dyn.dt.reshape(-1), 2)                  # [1, 2B]

    def interp(m0, mx, my, phi, gxx, gyy):
        return ap(m0, phi) + ap(mx, gxx) + ap(my, gyy)

    phi_cell = interp(ops.n2c_m0, ops.n2c_mx, ops.n2c_my,
                      collection, gx, gy)              # [Nc, 7B]
    gx5, gy5 = gx[:, : 5 * b], gy[:, : 5 * b]
    # ONE wide n2f_m0 apply for [phi5 | gx5 | gy5 | y]
    y_cm = pack_cm(dyn.target_uv)                      # [Np, 2B]
    face_m0 = ap(
        ops.n2f_m0,
        torch.cat([collection[:, : 5 * b], gx5, gy5, y_cm], dim=-1))
    phi_face = face_m0[:, : 5 * b] + \
        ap(ops.n2f_mx, gx5) + \
        ap(ops.n2f_my, gy5)                            # [E, 5B]
    gx_face = face_m0[:, 5 * b: 10 * b]                # [E, 5B]
    gy_face = face_m0[:, 10 * b: 15 * b]
    y_face = face_m0[:, 15 * b: 17 * b]                # [E, 2B]

    def fix_bc(face_uv):
        out = torch.where(ops.face_inflow > 0, y_face, face_uv)
        return torch.where(ops.face_wall > 0, torch.zeros_like(out), out)
    uv_face_new = fix_bc(phi_face[:, : 2 * b])
    uv_face_hat = fix_bc(phi_face[:, 3 * b: 5 * b])
    p_face_new = phi_face[:, 2 * b: 3 * b]             # [E, B]

    uvp_cell_new = phi_cell[:, : 3 * b]
    uv_cell_old = phi_cell[:, 5 * b: 7 * b]
    gx_uv_hat = gx_face[:, 3 * b: 5 * b]               # [E, 2B]
    gy_uv_hat = gy_face[:, 3 * b: 5 * b]

    diff2 = _row(theta[:, 4], 2)                       # [1, 2B]
    visc_out = diff2 * (gx_face[:, : 2 * b] * ops.s_out[:, 0:1]
                        + gy_face[:, : 2 * b] * ops.s_out[:, 1:2])
    resid_out = visc_out - _tile_ch(p_face_new, 2) * \
        ops.s_out.repeat_interleave(b, dim=1)          # [E, 2B]
    loss_press = safe_sqrt(sp_sum(
        (resid_out.reshape(-1, 2, b) ** 2).sum(dim=(0, 1))))      # [B]

    unsteady_cell = ((uvp_cell_new[:, : 2 * b] - uv_cell_old) / dt2) \
        * cells_area

    def pool2(per_cell):                               # [Nc, 2B] -> [2, B]
        return safe_sqrt(sp_sum((per_cell.reshape(-1, 2, b) ** 2)
                                .sum(dim=0)))

    if conserved_form:
        conv2 = _row(theta[:, 2], 2)
        gradp = _row(theta[:, 3], 1)                   # [1, B]
        u_hat2 = _tile_ch(uv_face_hat[:, : b], 2)      # [u,u]
        v_hat2 = _tile_ch(uv_face_hat[:, b: 2 * b], 2)
        mx = conv2 * uv_face_hat * u_hat2 - diff2 * gx_uv_hat
        my = conv2 * uv_face_hat * v_hat2 - diff2 * gy_uv_hat
        gp = gradp * p_face_new                        # [E, B]
        mx = torch.cat([mx[:, : b] + gp, mx[:, b: 2 * b]], dim=-1)
        my = torch.cat([my[:, : b], my[:, b: 2 * b] + gp], dim=-1)
        fx = ap(ops.flux_x, torch.cat(
            [uv_face_new[:, : b], mx], dim=-1))        # [Nc, 3B]
        fy = ap(ops.flux_y, torch.cat(
            [uv_face_new[:, b: 2 * b], my], dim=-1))
        cell_div = fx[:, : b] + fy[:, : b]             # [Nc, B]
        loss_cont = safe_sqrt(sp_sum((cell_div ** 2).sum(dim=0))) \
            * theta[:, 1]
        j_x = fx[:, b:] + fy[:, b:]                    # [Nc, 2B]
        rhs = j_x - _row(theta[:, 5], 2) * cells_area
        loss_mom_cell = _row(theta[:, 0], 2) * unsteady_cell + rhs
        loss_mom = pool2(loss_mom_cell) * dyn.sigma[:, 0:2].T   # [2, B]
    else:
        g_cell = ap(ops.n2c_m0, torch.cat([gx5, gy5], dim=-1))
        gx_cell, gy_cell = g_cell[:, : 5 * b], g_cell[:, 5 * b:]
        uv_cell_hat = phi_cell[:, 3 * b: 5 * b]

        cell_div = (gx_cell[:, : b] + gy_cell[:, b: 2 * b]) * cells_area
        loss_cont = safe_sqrt(sp_sum((cell_div ** 2).sum(dim=0))) \
            * theta[:, 1]

        conv2 = _row(theta[:, 2], 2)
        convection_cell = (gx_cell[:, 3 * b: 5 * b]
                           * _tile_ch(uv_cell_hat[:, : b], 2)
                           + gy_cell[:, 3 * b: 5 * b]
                           * _tile_ch(uv_cell_hat[:, b: 2 * b], 2)) \
            * cells_area
        grad_p_cell = gx_cell[:, 2 * b: 3 * b]
        grad_p_cell = torch.cat(
            [grad_p_cell, gy_cell[:, 2 * b: 3 * b]], dim=-1) * cells_area
        visc_cell = ap(ops.flux_x, gx_uv_hat) + ap(ops.flux_y, gy_uv_hat)
        loss_mom_cell = (_row(theta[:, 0], 2) * unsteady_cell
                         + conv2 * convection_cell
                         + _row(theta[:, 3], 2) * grad_p_cell
                         - diff2 * visc_cell
                         - _row(theta[:, 5], 2) * cells_area)
        loss_mom = pool2(loss_mom_cell) * dyn.sigma[:, 0:2].T

    if ncn_smooth:
        rt_uvp_cm = ap(ops.c2n, uvp_cell_new)
    else:
        rt_uvp_cm = pack_cm(uvp_new)

    losses = FVLosses(cont=loss_cont, mom_x=loss_mom[0],
                      mom_y=loss_mom[1], press=loss_press)
    return losses, unpack_cm(rt_uvp_cm, b), unpack_cm(uvp_cell_new, b)
