"""Taylor-expansion interpolation operators between mesh entities.

Counterpart of `gen_fvgn_tpu/ops/interp.py` (`_taylor_correction`,
`node_to_cell`, `node_to_face`, `face_to_node`, `cell_to_node`), on
batch-major tensors: every array carries a leading batch axis [B, ...] and
every index array is per sample ([B, M], or [B, 2, E] for face_node), where
the JAX functions see one graph under a vmap.

Shapes per sample: N nodes, E faces, Nc cells, Ck flat cell slots. `phi`
may be [B, N, C] (values) or [B, N, C, 2] (per-channel gradients being
interpolated); `grad` is one Taylor order higher.
"""

from __future__ import annotations

from typing import Optional

import torch

from gen_fvgn_tpu_torch.ops.segment import (gather_rows, segment_mean,
                                            segment_sum)


def _taylor_correction(r: torch.Tensor, grad_at_src: Optional[torch.Tensor],
                       hess_at_src: Optional[torch.Tensor]):
    """r·∇φ (+ ½ rᵀHr) per gathered source row: r [B, M, 2], grad_at_src
    [B, M, C, 2], hess_at_src [B, M, C, 2, 2]; [B, M, C] (0.0 when both
    corrections are absent)."""
    corr = 0.0
    if grad_at_src is not None:
        corr = torch.einsum("bmd,bmcd->bmc", r, grad_at_src)
    if hess_at_src is not None:
        corr = corr + 0.5 * torch.einsum("bmd,bmcde,bme->bmc", r,
                                         hess_at_src, r)
    return corr


def _extrapolate(phi, grad, hessian, idx, r):
    """phi at the rows `idx`, Taylor-extrapolated by r: values get the
    gradient (and Hessian) correction; gradients [.., C, 2] get their
    Hessian `grad` applied, or pass as they are."""
    src = gather_rows(phi, idx)
    if src.ndim == idx.ndim + 2:
        if grad is None:
            return src
        return src + torch.einsum("bmd,bmcde->bmce", r,
                                  gather_rows(grad, idx))
    return src + _taylor_correction(
        r, None if grad is None else gather_rows(grad, idx),
        None if hessian is None else gather_rows(hessian, idx))


def node_to_cell(phi, grad, hessian, cells_node, cells_index, pos, centroid,
                 n_cells: int, slot_mask=None) -> torch.Tensor:
    """2nd-order node→cell: Taylor-extrapolate each cell's nodes to the
    centroid, then average."""
    r = gather_rows(centroid, cells_index) - gather_rows(pos, cells_node)
    vals = _extrapolate(phi, grad, hessian, cells_node, r)
    return segment_mean(vals, cells_index, n_cells, slot_mask)


def node_to_face(phi, grad, hessian, face_node, face_center,
                 pos) -> torch.Tensor:
    """2nd-order node→face: Taylor-extrapolate both endpoints to the face
    center and average. Padded faces give rows that downstream masks
    ignore."""
    out = 0.0
    for side in (0, 1):
        idx = face_node[:, side]
        r = face_center - gather_rows(pos, idx)                  # [B, E, 2]
        out = out + _extrapolate(phi, grad, hessian, idx, r)
    return 0.5 * out


def face_to_node(face_phi, face_node, n_nodes: int,
                 face_mask=None) -> torch.Tensor:
    """Mean of incident face values at each node (both endpoints)."""
    both = torch.cat([face_phi, face_phi], dim=1)
    idx = torch.cat([face_node[:, 1], face_node[:, 0]], dim=1)
    mask = None if face_mask is None else torch.cat([face_mask, face_mask],
                                                    dim=1)
    return segment_mean(both, idx, n_nodes, mask)


def cell_to_node(cell_phi, cell_grad, cells_node, cells_index, centroid, pos,
                 n_nodes: int, slot_mask=None) -> torch.Tensor:
    """Inverse-distance-weighted cell→node scatter with an optional gradient
    correction."""
    r = gather_rows(pos, cells_node) - gather_rows(centroid, cells_index)
    dist = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    w = 1.0 / torch.where(dist > 0, dist, torch.ones_like(dist))
    vals = gather_rows(cell_phi, cells_index)
    if cell_grad is not None:
        vals = vals + _taylor_correction(
            r, gather_rows(cell_grad, cells_index), None)
    num = segment_sum(vals * w, cells_node, n_nodes, slot_mask)
    den = segment_sum(w, cells_node, n_nodes, slot_mask)
    return num / torch.clamp(den, min=1e-12)
