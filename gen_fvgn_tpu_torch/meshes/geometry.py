"""Geometric mesh compiler (offline ETL, host-side NumPy).

Derives every geometric quantity the device pipeline needs from the raw
(node positions, node types, ragged cell→node incidence) description:
faces, face types/areas/centers, cell centroids/areas, outward unit normals
(validated by the divergence theorem), neighbour cells, and the WLSQ stencil
graph. Behavior parity with reference `src/Extract_mesh/parse_to_h5.py`
(`extract_mesh_state` :257-496, `build_k_hop_edge_index` :228-254,
`compose_support_face_node_x` :132-150, `seperate_domain` :196-226), fully
vectorized (the reference loops per cell in Python for the shoelace check).

Ragged representation: cells are stored as flat (cells_node, cells_index)
pairs — `cells_node[i]` is a node id, `cells_index[i]` the id of the cell it
belongs to. Slots of one cell are contiguous and CCW-ordered after
`compile_mesh`. This supports mixed tri/quad/poly meshes with one layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.sparse as sp

from gen_fvgn_tpu_torch.utils.types import NodeType

_BOUNDARY = np.asarray(
    [int(t) for t in (NodeType.INFLOW, NodeType.OUTFLOW, NodeType.WALL_BOUNDARY,
                      NodeType.PRESS_POINT, NodeType.IN_WALL)]
)


def _next_slot(cells_index: np.ndarray) -> np.ndarray:
    """For flat ragged cell slots, the index of the next slot within the same
    cell (wrapping from the last slot back to the first). Requires slots of a
    cell to be contiguous."""
    n = cells_index.shape[0]
    nxt = np.arange(1, n + 1)
    # positions where the next slot belongs to a different cell -> wrap to the
    # first slot of this cell.
    is_last = np.empty(n, dtype=bool)
    is_last[:-1] = cells_index[1:] != cells_index[:-1]
    is_last[-1] = True
    # first slot position of each cell, gathered per slot
    first_of_cell = np.zeros(n, dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, cells_index[1:] != cells_index[:-1]])
    lengths = np.diff(np.r_[starts, n])
    first_of_cell = np.repeat(starts, lengths)
    nxt[is_last] = first_of_cell[is_last]
    return nxt


def unique_faces(cells_node: np.ndarray, cells_index: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract unique undirected faces from ragged cells.

    Returns (face_node [2, E] with face_node[0] < face_node[1],
             cells_face [ΣC_n] mapping the cell-edge slot starting at
             cells_node[i] to its global face id).

    Parity: parse_comsol.py `element_to_faces` :426-453 + np.unique inverse
    (:484-485), generalized to ragged cells.
    """
    nxt = _next_slot(cells_index)
    raw = np.stack([cells_node, cells_node[nxt]], axis=0)  # [2, ΣC_n]
    raw_sorted = np.sort(raw, axis=0)
    face_node, cells_face = np.unique(raw_sorted, axis=1, return_inverse=True)
    return face_node.astype(np.int64), cells_face.reshape(-1).astype(np.int64)


def _segment_sum(src: np.ndarray, index: np.ndarray, num: int) -> np.ndarray:
    out = np.zeros((num,) + src.shape[1:], dtype=src.dtype)
    np.add.at(out, index, src)
    return out


def _segment_mean(src: np.ndarray, index: np.ndarray, num: int) -> np.ndarray:
    s = _segment_sum(src, index, num)
    cnt = np.bincount(index, minlength=num).astype(src.dtype)
    cnt = np.maximum(cnt, 1)
    return s / cnt.reshape((num,) + (1,) * (src.ndim - 1))


def sort_cells_ccw(pos, face_center, cells_node, cells_face, cells_index, centroid):
    """Reorder cell slots so that each cell's nodes (and, independently, its
    faces) wind counter-clockwise around the centroid. Cells are regrouped by
    size (all triangles, then all quads, ...), preserving cells_index values.

    Parity: parse_to_h5.py `sort_vertices_ccw` :55-110.
    """
    n_cells = int(cells_index.max()) + 1
    size_of_cell = np.bincount(cells_index, minlength=n_cells)
    new_node, new_face, new_idx = [], [], []
    for ct in np.unique(size_of_cell[size_of_cell > 0]):
        mask = (size_of_cell == ct)[cells_index]
        sub_node = cells_node[mask].reshape(-1, ct)
        sub_face = cells_face[mask].reshape(-1, ct)
        sub_idx = cells_index[mask].reshape(-1, ct)
        ctr = centroid[sub_idx[:, 0]][:, None, :]          # [nc, 1, 2]

        rel_n = pos[sub_node] - ctr
        order_n = np.argsort(np.arctan2(rel_n[..., 1], rel_n[..., 0]), axis=1)
        rel_f = face_center[sub_face] - ctr
        order_f = np.argsort(np.arctan2(rel_f[..., 1], rel_f[..., 0]), axis=1)

        new_node.append(np.take_along_axis(sub_node, order_n, axis=1).reshape(-1))
        new_face.append(np.take_along_axis(sub_face, order_f, axis=1).reshape(-1))
        new_idx.append(sub_idx.reshape(-1))
    return (np.concatenate(new_node), np.concatenate(new_face),
            np.concatenate(new_idx))


def classify_faces(face_node: np.ndarray, node_type: np.ndarray) -> np.ndarray:
    """Face types from endpoint node types.

    A face is boundary iff both endpoints are boundary nodes. Precedence rules
    at corners match parse_to_h5.py :306-371: INFLOW wins over WALL at
    inflow/wall junctions; OUTFLOW wins over INFLOW at inflow/outflow
    junctions.
    """
    lt, rt = node_type[face_node[0]], node_type[face_node[1]]
    is_b_l, is_b_r = np.isin(lt, _BOUNDARY), np.isin(rt, _BOUNDARY)
    face_type = np.full(face_node.shape[1], int(NodeType.NORMAL), dtype=np.int64)

    inflow = (is_b_l & (rt == NodeType.INFLOW)) | (is_b_r & (lt == NodeType.INFLOW))
    face_type[inflow] = NodeType.INFLOW

    # WALL assignment: the side-set for the "other" endpoint excludes INFLOW in
    # one orientation (parity with the asymmetric masks at parse_to_h5.py
    # :330-348 — a WALL|INFLOW face stays INFLOW).
    other_r = np.isin(rt, _BOUNDARY[_BOUNDARY != NodeType.INFLOW])
    wall = (is_b_l & (rt == NodeType.WALL_BOUNDARY)) | \
           (other_r & (lt == NodeType.WALL_BOUNDARY))
    face_type[wall] = NodeType.WALL_BOUNDARY

    outflow = (is_b_l & (rt == NodeType.OUTFLOW)) | (other_r & (lt == NodeType.OUTFLOW))
    face_type[outflow] = NodeType.OUTFLOW
    return face_type


def shoelace_areas(pos, cells_node, cells_index, n_cells) -> np.ndarray:
    """Per-cell polygon areas by the shoelace formula over CCW-ordered slots.

    Parity oracle: parse_to_h5.py `polygon_area` :45-53 (reference evaluates it
    in a per-cell Python loop; this is the vectorized equivalent).
    """
    nxt = _next_slot(cells_index)
    x, y = pos[cells_node, 0], pos[cells_node, 1]
    xn, yn = pos[cells_node[nxt], 0], pos[cells_node[nxt], 1]
    cross = x * yn - xn * y
    return 0.5 * np.abs(_segment_sum(cross, cells_index, n_cells))


def k_hop_edges(edge_index_twoway: np.ndarray, k: int, n_nodes: int) -> np.ndarray:
    """Node pairs connected by exactly-k-step walks on the (two-way) face
    graph, as sparse boolean matrix powers.

    Parity: parse_to_h5.py `build_k_hop_edge_index` :228-254 (torch.sparse.mm
    powers → scipy csr powers).
    """
    data = np.ones(edge_index_twoway.shape[1], dtype=bool)
    adj = sp.csr_matrix((data, (edge_index_twoway[0], edge_index_twoway[1])),
                        shape=(n_nodes, n_nodes))
    m = adj
    for _ in range(k - 1):
        m = m @ adj
    coo = m.tocoo()
    return np.stack([coo.row.astype(np.int64), coo.col.astype(np.int64)], axis=0)


def build_stencil(face_node: np.ndarray, face_node_x: np.ndarray,
                  n_nodes: int, k_hop: int = 2) -> np.ndarray:
    """Extended WLSQ stencil: 1-ring cell-sharing pairs (face_node_x) plus the
    union of k-hop neighbour pairs for k = 1..k_hop, as one-way edges.

    NOTE (parity): the reference concatenates the k-hop set onto face_node_x
    WITHOUT deduplicating between the two (Load_mesh.py:474-486), so pairs
    present in both contribute twice to the WLSQ moments (doubled weight).
    We reproduce that exactly — it is part of the trained numerics.

    The extra pairs come from sparse boolean matrix powers (k_hop_edges),
    sorted and deduplicated among themselves.
    """
    twoway = np.concatenate([face_node, face_node[::-1]], axis=1)
    hops = [k_hop_edges(twoway, k, n_nodes) for k in range(1, k_hop + 1)]
    extra = np.concatenate(hops, axis=1)
    extra = extra[:, extra[0] != extra[1]]
    extra = np.unique(np.sort(extra, axis=0), axis=1)
    return np.concatenate([face_node_x, extra], axis=1)


def cell_node_pairs(cells_node: np.ndarray, cells_index: np.ndarray) -> np.ndarray:
    """All unordered node pairs sharing a cell (the 1-ring WLSQ stencil
    `face_node_x`). Parity: parse_to_h5.py `compose_support_face_node_x`
    :132-150 (+ the per-domain loop at :474-492), vectorized for ragged
    cells via intra-cell pairwise combinations.
    """
    n_cells = int(cells_index.max()) + 1
    size_of_cell = np.bincount(cells_index, minlength=n_cells)
    pairs = []
    for ct in np.unique(size_of_cell[size_of_cell > 0]):
        mask = (size_of_cell == ct)[cells_index]
        sub = cells_node[mask].reshape(-1, ct)             # [nc, ct]
        ii, jj = np.triu_indices(ct, k=1)
        p = np.stack([sub[:, ii].reshape(-1), sub[:, jj].reshape(-1)], axis=0)
        pairs.append(p)
    allp = np.concatenate(pairs, axis=1)
    allp = allp[:, allp[0] != allp[1]]
    return np.unique(np.sort(allp, axis=0), axis=1)


def compile_mesh(mesh: Dict[str, np.ndarray], validate: bool = True) -> Dict[str, np.ndarray]:
    """Full geometric compile. Input: dict from `comsol_to_mesh` (or the
    tecplot parser). Output: the complete .h5-schema dict (SURVEY.md §2.1).

    Raises ValueError when the divergence-theorem normal check fails; silently
    substitutes shoelace areas when the surface-integral areas disagree
    (parity: parse_to_h5.py :437-472).
    """
    pos = np.asarray(mesh["node|pos"], dtype=np.float64)
    node_type = np.asarray(mesh["node|node_type"], dtype=np.int64)
    cells_node = np.asarray(mesh["cells_node"], dtype=np.int64)
    cells_index = np.asarray(mesh["cells_index"], dtype=np.int64)
    n_nodes = pos.shape[0]
    n_cells = int(cells_index.max()) + 1

    if "face|face_node" in mesh and "cells_face" in mesh:
        face_node = np.asarray(mesh["face|face_node"], dtype=np.int64)
        cells_face = np.asarray(mesh["cells_face"], dtype=np.int64)
    else:
        face_node, cells_face = unique_faces(cells_node, cells_index)

    centroid = _segment_mean(pos[cells_node], cells_index, n_cells)
    face_center = 0.5 * (pos[face_node[0]] + pos[face_node[1]])

    cells_node, cells_face, cells_index = sort_cells_ccw(
        pos, face_center, cells_node, cells_face, cells_index, centroid)

    face_type = classify_faces(face_node, node_type)
    face_area = np.linalg.norm(pos[face_node[0]] - pos[face_node[1]], axis=1)

    n_faces = face_node.shape[1]
    sender_cell = np.full(n_faces, -1, dtype=np.int64)
    receiver_cell = np.full(n_faces, n_cells + 1, dtype=np.int64)
    np.maximum.at(sender_cell, cells_face, cells_index)
    np.minimum.at(receiver_cell, cells_face, cells_index)
    neighbour_cell = np.stack([receiver_cell, sender_cell], axis=0)

    # outward unit normals per cell-face slot
    diff = pos[face_node[0]] - pos[face_node[1]]
    unv = np.stack([-diff[:, 1], diff[:, 0]], axis=1)
    unv /= np.linalg.norm(unv, axis=1, keepdims=True)
    if validate and not np.isfinite(unv).all():
        raise ValueError("degenerate face (zero length) produced a non-finite normal")

    slot_unv = unv[cells_face]
    outward = np.sum((face_center[cells_face] - centroid[cells_index]) * slot_unv,
                     axis=1, keepdims=True) > 0.0
    slot_unv = np.where(outward, slot_unv, -slot_unv)

    surface_vec = slot_unv * face_area[cells_face, None]
    closure = _segment_sum(surface_vec, cells_index, n_cells)
    if validate and not np.allclose(closure, 0.0, rtol=1e-5, atol=1e-8):
        raise ValueError("divergence-theorem check failed: cell surface vectors "
                         f"do not close (max |Σ| = {np.abs(closure).max():.3e})")

    # cell areas: ∮ ½ x·dS, cross-checked against the shoelace formula
    integrand = 0.5 * np.sum(face_center[cells_face] * surface_vec, axis=1)
    cells_area = _segment_sum(integrand, cells_index, n_cells)
    area_check = shoelace_areas(pos, cells_node, cells_index, n_cells)
    if not np.allclose(cells_area, area_check, rtol=1e-5, atol=1e-8):
        cells_area = area_check

    face_node_x = cell_node_pairs(cells_node, cells_index)

    out = dict(mesh)
    out.update({
        "node|pos": pos,
        "node|node_type": node_type,
        "node|surf_mask": np.asarray(mesh.get("node|surf_mask",
                                              np.zeros(n_nodes, bool))),
        "face|face_node": face_node,
        "face|face_type": face_type,
        "face|face_area": face_area[:, None],
        "face|face_center_pos": face_center,
        "face|neighbour_cell": neighbour_cell,
        "cells_node": cells_node,
        "cells_index": cells_index,
        "cells_face": cells_face,
        "cell|centroid": centroid,
        "cell|cells_area": cells_area,
        "unit_norm_v": slot_unv,
        "face_node_x": face_node_x,
    })
    return out
