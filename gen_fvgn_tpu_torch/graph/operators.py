"""Per-mesh static operator bundle for the sparse-operator engine.

Counterpart of `gen_fvgn_tpu/graph/operators.py`. Builds, once per case,
every sparse linear operator the forward pass needs, as CSR `LinOp`s
(ops/blocksparse.py):

  model:  adj (neighbour sum), gather_s/gather_r (edge←node), edge_diff,
          scat_r/scat_s (node←edge halves), degree vector, the composed
          nbr_r = adj @ scat_r, nbr_s = adj @ scat_s (node_agg "composed"),
          and the composed gathers gsadj = Gs @ adj, gradj = Gr @ adj
          (edge_gather "composed")
  wlsq:   the folded gradient operator [N·2 ← N] — accumulation,
          conditioning and the per-node solve collapse into one static
          sparse matrix
  fv:     node→cell / node→face Taylor interpolation (value + r·∇ terms),
          cell→node inverse-distance, slot-flux accumulation [Nc ← E] with
          surface-vector weights, outflow-face traction weights

The JAX bundle also carries layout metadata of its tiled kernels (window
tables, paired-gather tables, int8 panels); that is layout, not function,
and has no counterpart here.

Mesh orderings: callers RCM-reorder the mesh first (rcm_reorder) so every
operator is banded — on the GPU that keeps a row's gathered operand rows
close together in memory; the Hilbert-curve order (`hilbert_order`) is the
alternative.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from gen_fvgn_tpu_torch.ops.blocksparse import (CsrOp, LinOp, build_linop,
                                                gather_coo, signed_diff_coo)
from gen_fvgn_tpu_torch.utils.types import NodeType


def hilbert_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Node permutation by the Hilbert space-filling-curve index of the 2-D
    positions (locality without explicit banding). Coordinates normalize
    into a 2^bits grid; the d2xy rotation recurrence runs vectorized over
    all nodes per bit level. The JAX package's permutation, bit for bit."""
    p = pos[:, :2].astype(np.float64)
    lo, hi = p.min(axis=0), p.max(axis=0)
    span = np.maximum(hi - lo, 1e-300)
    n_side = 1 << bits
    xy = np.minimum((p - lo) / span * n_side, n_side - 1).astype(np.uint64)
    x, y = xy[:, 0].copy(), xy[:, 1].copy()
    d = np.zeros(pos.shape[0], np.uint64)
    s = np.uint64(n_side // 2)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate the quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x = np.where(swap, y_f, x)
        y = np.where(swap, x_f, y)
        x = np.where(flip, np.uint64(s - 1) - x, x)
        y = np.where(flip, np.uint64(s - 1) - y, y)
        s >>= np.uint64(1)
    return np.argsort(d, kind="stable")


def rcm_reorder(raw_mesh: Dict[str, np.ndarray],
                method: str = "rcm") -> Dict[str, np.ndarray]:
    """Node reordering + cell reordering by minimum new node id, applied to
    a RAW mesh dict (before compile_mesh). method="rcm" (default):
    Reverse-Cuthill-McKee on the face adjacency, so every derived operator
    is banded; method="hilbert": the Hilbert-curve order of the node
    positions (`hilbert_order`)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from gen_fvgn_tpu_torch.meshes.geometry import unique_faces

    pos = raw_mesh["node|pos"]
    cells_node = raw_mesh["cells_node"]
    cells_index = raw_mesh["cells_index"]
    n = pos.shape[0]

    if method == "hilbert":
        perm = hilbert_order(pos)
    elif method == "rcm":
        face_node, _ = unique_faces(cells_node, cells_index)
        adj = sp.csr_matrix(
            (np.ones(2 * face_node.shape[1], bool),
             (np.concatenate([face_node[0], face_node[1]]),
              np.concatenate([face_node[1], face_node[0]]))), shape=(n, n))
        perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    else:
        raise ValueError(f"unknown ordering method {method!r}")
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)

    new_cells_node = rank[cells_node]

    # reorder cells by their minimum new node id (stable)
    n_cells = int(cells_index.max()) + 1
    cell_min = np.full(n_cells, n, np.int64)
    np.minimum.at(cell_min, cells_index, new_cells_node)
    cell_order = np.argsort(cell_min, kind="stable")
    cell_rank = np.empty(n_cells, np.int64)
    cell_rank[cell_order] = np.arange(n_cells)

    new_idx = cell_rank[cells_index]
    slot_order = np.argsort(new_idx, kind="stable")

    out = dict(raw_mesh)
    out["node|pos"] = pos[perm]
    out["node|node_type"] = raw_mesh["node|node_type"][perm]
    if "node|surf_mask" in raw_mesh:
        out["node|surf_mask"] = raw_mesh["node|surf_mask"][perm]
    out["cells_node"] = new_cells_node[slot_order]
    out["cells_index"] = new_idx[slot_order]
    # drop any stale compiled fields — caller re-runs compile_mesh
    for key in list(out.keys()):
        if key.startswith(("face|", "cell|")) or key in (
                "cells_face", "unit_norm_v", "face_node_x", "stencil",
                "wlsq_S", "wlsq_B", "wlsq_scale"):
            out.pop(key, None)
    return out


@dataclass
class MeshOperators:
    # model message passing
    adj: LinOp          # [N←N] two-way neighbour sum
    deg: torch.Tensor   # [N, 1] two-way degree
    gather_s: LinOp     # [E←N]
    gather_r: LinOp     # [E←N]
    edge_diff: LinOp    # [E←N] x[s] − x[r]
    scat_r: LinOp       # [N←E]
    scat_s: LinOp       # [N←E]
    # WLSQ folded derivative operator [N·n_q ← N]
    wlsq: LinOp
    # FV interpolation / accumulation
    n2c_m0: LinOp       # [Nc←N] cell mean
    n2c_mx: LinOp       # [Nc←N] mean of r_x ·
    n2c_my: LinOp       # [Nc←N]
    n2f_m0: LinOp       # [E←N] face endpoint mean
    n2f_mx: LinOp       # [E←N]
    n2f_my: LinOp       # [E←N]
    c2n: LinOp          # [N←Nc] normalized inverse-distance
    flux_x: LinOp       # [Nc←E] Σ_slots S_x ·
    flux_y: LinOp       # [Nc←E]
    # static face/cell data
    face_inflow: torch.Tensor   # [E, 1] 1.0 on INFLOW faces
    face_wall: torch.Tensor     # [E, 1] 1.0 on WALL faces
    s_out: torch.Tensor         # [E, 2] outward surface vector on OUTFLOW faces
    # composed NodeBlock aggregation operators (cfg.node_agg "composed"):
    # nbr_r = adj @ scat_r, nbr_s = adj @ scat_s [N←E]
    nbr_r: Optional[LinOp] = None
    nbr_s: Optional[LinOp] = None
    # composed EdgeBlock gathers (cfg.edge_gather "composed"): gsadj =
    # Gs @ adj, gradj = Gr @ adj [E←N]; take_side(adj @ (x·W)) ==
    # gsadj @ (x·W), and padded rows are zero (no take row-0 carve-out)
    gsadj: Optional[LinOp] = None
    gradj: Optional[LinOp] = None
    # number of folded WLSQ derivative rows per node (static metadata)
    wlsq_n_q: int = 2

    def to(self, device) -> "MeshOperators":
        # a direction shared by two operators (gsadj / gradj are nbr_s /
        # nbr_r transposed) moves once and stays shared
        done = {}

        def move(op: CsrOp) -> CsrOp:
            if id(op) not in done:
                done[id(op)] = op.to(device)
            return done[id(op)]
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, LinOp):
                v = LinOp(fwd=move(v.fwd), bwd=move(v.bwd))
            elif isinstance(v, torch.Tensor):
                v = v.to(device)
            moved[f.name] = v
        return MeshOperators(**moved)


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_mesh_operators(mesh: Dict[str, np.ndarray], order: str,
                         sizes, tile: int = 256,
                         model_ops_bf16: bool = True,
                         wlsq_rows: str = "grad",
                         node_agg: str = "split",
                         edge_gather: str = "take") -> MeshOperators:
    """Build all operators for ONE compiled+prepared mesh (with stencil and
    WLSQ statics attached), padded to `sizes` (PadSizes). Host-side; move
    the bundle with `.to(device)`.

    model_ops_bf16: store the structural (0/±1 and small path counts,
    exactly representable) message-passing operators as bfloat16 operators
    — they act on network activations that are bf16 anyway. FV/WLSQ
    operators stay float32.

    wlsq_rows: "grad" folds only the gradient rows q=0,1; "full" folds all
    k rows of the order-k solve. `tile` only sets the padded row count of
    the WLSQ operator, as in the JAX package.

    node_agg "composed" builds nbr_r / nbr_s; edge_gather "composed" builds
    gsadj / gradj. (The JAX package builds both pairs whenever node_agg is
    "composed" and takes the gathers only under its process-wide switch
    `use_composed_gather()`; here each pair follows its own Config field.)"""
    from gen_fvgn_tpu_torch.ops.wlsq import WLSQ_DIM, odd_sign_vector

    if edge_gather not in ("take", "composed"):
        raise ValueError(f"edge_gather must be 'take' or 'composed', got "
                         f"{edge_gather!r}")

    pos = mesh["node|pos"].astype(np.float64)
    face_node = mesh["face|face_node"].astype(np.int64)
    cells_node = mesh["cells_node"].astype(np.int64)
    cells_face = mesh["cells_face"].astype(np.int64)
    cells_index = mesh["cells_index"].astype(np.int64)
    centroid = mesh["cell|centroid"].astype(np.float64)
    face_center = mesh["face|face_center_pos"].astype(np.float64)
    face_area = mesh["face|face_area"].reshape(-1).astype(np.float64)
    face_type = mesh["face|face_type"].reshape(-1)
    slot_unv = mesh["unit_norm_v"].astype(np.float64)
    n = pos.shape[0]
    e = face_node.shape[1]
    nc = centroid.shape[0]
    k = WLSQ_DIM[order]

    n_q = 2 if wlsq_rows == "grad" else k
    np_pad = sizes.n_nodes
    e_pad = sizes.n_faces
    c_pad = sizes.n_cells
    nk_pad = _pad_to(np_pad * n_q, tile)

    s, r = face_node[0], face_node[1]

    # model ops (structural → bf16-safe)
    mdt = "bfloat16" if model_ops_bf16 else np.float32
    rows = np.concatenate([r, s]); cols = np.concatenate([s, r])
    ones2 = np.ones(2 * e, np.float32)
    adj = build_linop(rows, cols, ones2, np_pad, np_pad, mdt)
    deg = np.zeros((np_pad, 1), np.float32)
    np.add.at(deg, rows, 1.0)

    # pure row-gathers: index_select forward; padded rows index 0
    s_take = np.zeros(e_pad, np.int64); s_take[:e] = s
    r_take = np.zeros(e_pad, np.int64); r_take[:e] = r
    gs = build_linop(*gather_coo(s), e_pad, np_pad, dtype=mdt, fwd_take=s_take)
    gr = build_linop(*gather_coo(r), e_pad, np_pad, dtype=mdt, fwd_take=r_take)
    ed = build_linop(*signed_diff_coo(face_node), e_pad, np_pad)
    e_idx = np.arange(e)
    scat_r = build_linop(r, e_idx, np.ones(e, np.float32), np_pad, e_pad, mdt)
    scat_s = build_linop(s, e_idx, np.ones(e, np.float32), np_pad, e_pad, mdt)

    # the composed operators, products of the structural ones on the host.
    # Entries are path counts (small integers), exactly representable in
    # bf16; rows past the real ones stay empty, so padded rows are zero
    import scipy.sparse as sp
    A = sp.csr_matrix((np.ones(2 * e, np.float64), (rows, cols)),
                      shape=(n, n))

    def composed(left, right, n_out, n_in):
        c = (left @ right).tocoo()
        return build_linop(c.row, c.col, c.data, n_out, n_in, mdt)

    nbr_r = nbr_s = gsadj = gradj = None
    if node_agg == "composed" or edge_gather == "composed":
        # nbr_r = adj @ scat_r, nbr_s = adj @ scat_s [N←E]
        Sr = sp.csr_matrix((np.ones(e, np.float64), (r, e_idx)), shape=(n, e))
        Ss = sp.csr_matrix((np.ones(e, np.float64), (s, e_idx)), shape=(n, e))
        nbr_r = composed(A, Sr, np_pad, e_pad)
        nbr_s = composed(A, Ss, np_pad, e_pad)
    if edge_gather == "composed":
        # gsadj = Gs @ adj, gradj = Gr @ adj [E←N]: adj is symmetric, so
        # they are nbr_s and nbr_r transposed, and share their arrays
        gsadj = LinOp(fwd=nbr_s.bwd, bwd=nbr_s.fwd)
        gradj = LinOp(fwd=nbr_r.bwd, bwd=nbr_r.fwd)
    if node_agg != "composed":
        nbr_r = nbr_s = None

    # ---- folded WLSQ operator ----
    stencil = mesh["stencil"].astype(np.int64)
    wB = mesh["wlsq_B"].astype(np.float64)          # [Es, k] unscaled rows
    colscale = mesh["wlsq_scale"].astype(np.float64)
    S = mesh["wlsq_S"].astype(np.float64)           # [N, k, k] incl. colscale
    signs = np.asarray(odd_sign_vector(order), np.float64)
    ss, rr = stencil[0], stencil[1]
    row_fwd = wB * colscale[rr]                     # [Es, k]
    row_rev = (wB * signs) * colscale[ss]
    sv_fwd = np.einsum("eql,el->eq", S[rr][:, :n_q], row_fwd)  # [Es, n_q]
    sv_rev = np.einsum("eql,el->eq", S[ss][:, :n_q], row_rev)

    qs = np.arange(n_q)
    # rows (target*n_q + q), 4 groups: (r,s,+f), (r,r,-f), (s,r,+v), (s,s,-v)
    def _rows(tgt):
        return (tgt[:, None] * n_q + qs[None, :]).reshape(-1)
    wl_rows = np.concatenate([_rows(rr), _rows(rr), _rows(ss), _rows(ss)])
    wl_cols = np.concatenate([
        np.repeat(ss, n_q), np.repeat(rr, n_q),
        np.repeat(rr, n_q), np.repeat(ss, n_q)])
    wl_vals = np.concatenate([
        sv_fwd.reshape(-1), -sv_fwd.reshape(-1),
        sv_rev.reshape(-1), -sv_rev.reshape(-1)])
    wlsq = build_linop(wl_rows, wl_cols, wl_vals, nk_pad, np_pad)

    # ---- interpolation operators ----
    slot_cnt = np.bincount(cells_index, minlength=nc).astype(np.float64)
    inv_cnt = 1.0 / np.maximum(slot_cnt, 1.0)
    r_n2c = centroid[cells_index] - pos[cells_node]          # [Ck, 2]
    w0 = inv_cnt[cells_index]
    n2c_m0 = build_linop(cells_index, cells_node, w0.astype(np.float32),
                         c_pad, np_pad)
    n2c_mx = build_linop(cells_index, cells_node,
                         (w0 * r_n2c[:, 0]).astype(np.float32), c_pad, np_pad)
    n2c_my = build_linop(cells_index, cells_node,
                         (w0 * r_n2c[:, 1]).astype(np.float32), c_pad, np_pad)

    e_both = np.concatenate([e_idx, e_idx])
    n_both = np.concatenate([s, r])
    r_n2f = np.concatenate([face_center - pos[s], face_center - pos[r]])
    half = np.full(2 * e, 0.5, np.float64)
    n2f_m0 = build_linop(e_both, n_both, half.astype(np.float32),
                         e_pad, np_pad)
    n2f_mx = build_linop(e_both, n_both,
                         (half * r_n2f[:, 0]).astype(np.float32),
                         e_pad, np_pad)
    n2f_my = build_linop(e_both, n_both,
                         (half * r_n2f[:, 1]).astype(np.float32),
                         e_pad, np_pad)

    # cell→node inverse-distance, normalization folded into the values
    r_c2n = pos[cells_node] - centroid[cells_index]
    w = 1.0 / np.maximum(np.linalg.norm(r_c2n, axis=1), 1e-12)
    denom = np.zeros(n, np.float64)
    np.add.at(denom, cells_node, w)
    c2n_vals = (w / denom[cells_node]).astype(np.float32)
    c2n = build_linop(cells_node, cells_index, c2n_vals, np_pad, c_pad)

    # slot-flux accumulation [Nc←E] with surface-vector weights
    svec = slot_unv * face_area[cells_face][:, None]          # [Ck, 2]
    flux_x = build_linop(cells_index, cells_face,
                         svec[:, 0].astype(np.float32), c_pad, e_pad)
    flux_y = build_linop(cells_index, cells_face,
                         svec[:, 1].astype(np.float32), c_pad, e_pad)

    # static face data
    face_inflow = np.zeros((e_pad, 1), np.float32)
    face_inflow[:e, 0] = (face_type == NodeType.INFLOW)
    face_wall = np.zeros((e_pad, 1), np.float32)
    face_wall[:e, 0] = (face_type == NodeType.WALL_BOUNDARY)
    s_out = np.zeros((e_pad, 2), np.float32)
    outflow_slots = (face_type[cells_face] == NodeType.OUTFLOW)
    s_out[cells_face[outflow_slots]] = svec[outflow_slots].astype(np.float32)

    return MeshOperators(
        adj=adj, deg=torch.from_numpy(deg), gather_s=gs, gather_r=gr,
        edge_diff=ed, scat_r=scat_r, scat_s=scat_s, wlsq=wlsq,
        n2c_m0=n2c_m0, n2c_mx=n2c_mx, n2c_my=n2c_my,
        n2f_m0=n2f_m0, n2f_mx=n2f_mx, n2f_my=n2f_my,
        c2n=c2n, flux_x=flux_x, flux_y=flux_y,
        face_inflow=torch.from_numpy(face_inflow),
        face_wall=torch.from_numpy(face_wall),
        s_out=torch.from_numpy(s_out),
        nbr_r=nbr_r, nbr_s=nbr_s, gsadj=gsadj, gradj=gradj, wlsq_n_q=n_q,
    )
