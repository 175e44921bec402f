"""Mesh statics from a raw mesh, in float64 NumPy.

A raw mesh is what the benchmark writes to disk: node positions, the
quadrilaterals as node lists, and the boundary segments with the boundary
condition each belongs to. From it this module derives the faces, their
types, centres, lengths, the cells' centroids and areas, each cell side's
outward unit normal, the node types and the two-way WLSQ stencil with its
least-squares gradient weights.

Conventions the system under test shares (Gen-FVGN's mesh pipeline):

* node types: inflow segments first, then wall segments (a node on both
  is IN_WALL), then outflow (walls and inflows keep their type);
* a face joins two nodes of one cell side; it is written with the smaller
  node number first, in whatever numbering the mesh is given;
* the WLSQ stencil is every pair of nodes that share a cell, plus the
  pairs joined by a walk of exactly k faces for k = 1 .. k_hop, the two
  lists concatenated without removing pairs they share (such a pair
  counts twice), weights 1/|d| on the 2nd-order Taylor displacement.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NORMAL, INFLOW, OUTFLOW, WALL, PRESS_POINT, IN_WALL = range(6)
_BOUNDARY = (INFLOW, OUTFLOW, WALL, PRESS_POINT, IN_WALL)


@dataclass
class RawMesh:
    pos: np.ndarray          # [N, 2]
    cells: np.ndarray        # [C, k] node ids of each cell (any winding)
    seg: np.ndarray          # [S, 2] boundary segments
    seg_kind: np.ndarray     # [S] "inflow" / "wall" / "outflow" codes 1/3/2

    def renumber(self, order: np.ndarray) -> "RawMesh":
        """The same mesh with node `order[i]` as node i."""
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        return RawMesh(self.pos[order], rank[self.cells], rank[self.seg],
                       self.seg_kind)


def cavity(n: int) -> RawMesh:
    """The unit square of n x n quadrilaterals, (n+1)^2 nodes numbered row
    by row from (0, 0); the top side (y = 1) is the moving lid (inflow),
    the other three sides walls."""
    xs = np.linspace(0.0, 1.0, n + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    pos = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    nid = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    a, b = nid[:-1, :-1].reshape(-1), nid[:-1, 1:].reshape(-1)
    c, d = nid[1:, 1:].reshape(-1), nid[1:, :-1].reshape(-1)
    cells = np.stack([a, b, c, d], axis=1)
    sides = [nid[0, :], nid[:, 0], nid[-1, :], nid[:, -1]]   # B, L, T, R
    seg = np.concatenate([np.stack([s[:-1], s[1:]], 1) for s in sides])
    kind = np.repeat(np.asarray([WALL, WALL, INFLOW, WALL]), n)
    return RawMesh(pos, cells, seg, kind)


def node_types(m: RawMesh) -> np.ndarray:
    t = np.full(m.pos.shape[0], NORMAL, np.int64)
    t[m.seg[m.seg_kind == INFLOW].reshape(-1)] = INFLOW
    on_wall = np.unique(m.seg[m.seg_kind == WALL].reshape(-1))
    was_in = t[on_wall] == INFLOW
    t[on_wall] = WALL
    t[on_wall[was_in]] = IN_WALL
    on_out = np.unique(m.seg[m.seg_kind == OUTFLOW].reshape(-1))
    keep = np.isin(t[on_out], (WALL, INFLOW))
    t[on_out[~keep]] = OUTFLOW
    return t


def _face_type(fn: np.ndarray, nt: np.ndarray) -> np.ndarray:
    a, b = nt[fn[0]], nt[fn[1]]
    ba, bb = np.isin(a, _BOUNDARY), np.isin(b, _BOUNDARY)
    bb_not_in = np.isin(b, [t for t in _BOUNDARY if t != INFLOW])
    ft = np.full(fn.shape[1], NORMAL, np.int64)
    ft[(ba & (b == INFLOW)) | (bb & (a == INFLOW))] = INFLOW
    ft[(ba & (b == WALL)) | (bb_not_in & (a == WALL))] = WALL
    ft[(ba & (b == OUTFLOW)) | (bb_not_in & (a == OUTFLOW))] = OUTFLOW
    return ft


def _walk_pairs(fn: np.ndarray, n: int, k: int) -> np.ndarray:
    """Unordered pairs [P, 2] (i < j) joined by a walk of exactly k
    faces: the pattern of the k-th power of the adjacency matrix."""
    import scipy.sparse as sps
    ones = np.ones(2 * fn.shape[1], bool)
    adj = sps.csr_matrix((ones, (np.concatenate([fn[0], fn[1]]),
                                 np.concatenate([fn[1], fn[0]]))),
                         shape=(n, n))
    walk = adj
    for _ in range(k - 1):
        walk = walk @ adj
    walk = walk.tocoo()
    p = np.stack([walk.row, walk.col], 1).astype(np.int64)
    return p[p[:, 0] < p[:, 1]]


@dataclass
class Statics:
    n_nodes: int
    n_cells: int
    pos: np.ndarray          # [N, 2]
    node_type: np.ndarray    # [N]
    face_node: np.ndarray    # [2, E], face_node[0] < face_node[1]
    face_type: np.ndarray    # [E]
    face_area: np.ndarray    # [E]
    face_center: np.ndarray  # [E, 2]
    centroid: np.ndarray     # [C, 2]
    cells_area: np.ndarray   # [C]
    slot_node: np.ndarray    # [S] node of each cell corner
    slot_face: np.ndarray    # [S] face of each cell side
    slot_cell: np.ndarray    # [S]
    slot_unv: np.ndarray     # [S, 2] outward unit normal of slot_face
    st_out: np.ndarray       # [M] two-way stencil: neighbour
    st_in: np.ndarray        # [M] two-way stencil: the node whose gradient
    st_w: np.ndarray         # [M, 2] d(grad)/d(phi_out - phi_in)


def taylor_2nd(d: np.ndarray) -> np.ndarray:
    dx, dy = d[:, 0:1], d[:, 1:2]
    return np.concatenate([dx, dy, 0.5 * dx ** 2, 0.5 * dy ** 2, dx * dy], 1)


def statics(m: RawMesh, k_hop: int = 2) -> Statics:
    pos = np.asarray(m.pos, np.float64)
    n, (c, k) = pos.shape[0], m.cells.shape
    nt = node_types(m)
    cell_of = np.repeat(np.arange(c), k)
    centroid = pos[m.cells].mean(axis=1)

    # cell corners counter-clockwise about the centroid
    rel = pos[m.cells] - centroid[:, None]
    ccw = np.take_along_axis(
        m.cells, np.argsort(np.arctan2(rel[..., 1], rel[..., 0]), 1), 1)
    nxt = np.roll(ccw, -1, axis=1)
    x, y = pos[ccw, 0], pos[ccw, 1]
    cells_area = 0.5 * np.abs((x * pos[nxt, 1] - pos[nxt, 0] * y).sum(1))

    sides = np.sort(np.stack([ccw, nxt], -1).reshape(-1, 2), axis=1)
    uniq, slot_face = np.unique(sides, axis=0, return_inverse=True)
    face_node = uniq.T.copy()
    slot_face = slot_face.reshape(-1)
    fa, fb = pos[face_node[0]], pos[face_node[1]]
    face_center = 0.5 * (fa + fb)
    face_area = np.linalg.norm(fa - fb, axis=1)
    nrm = np.stack([-(fa - fb)[:, 1], (fa - fb)[:, 0]], 1) \
        / face_area[:, None]
    unv = nrm[slot_face]
    out = np.sum((face_center[slot_face] - centroid[cell_of]) * unv, 1) > 0
    unv = np.where(out[:, None], unv, -unv)

    # WLSQ stencil
    ii, jj = np.triu_indices(k, 1)
    share = np.sort(np.stack([m.cells[:, ii].reshape(-1),
                              m.cells[:, jj].reshape(-1)], 1), axis=1)
    share = np.unique(share[share[:, 0] != share[:, 1]], axis=0)
    hops = np.unique(np.concatenate(
        [_walk_pairs(face_node, n, h) for h in range(1, k_hop + 1)]), axis=0)
    one_way = np.concatenate([share, hops]).T
    st_out = np.concatenate([one_way[0], one_way[1]])
    st_in = np.concatenate([one_way[1], one_way[0]])
    d = pos[st_out] - pos[st_in]
    disp = taylor_2nd(d)
    w = 1.0 / np.linalg.norm(d, axis=1, keepdims=True)
    moments = np.zeros((n, 5, 5))
    np.add.at(moments, st_in, (disp * w)[:, :, None] * disp[:, None, :])
    inv = np.linalg.inv(moments)
    st_w = np.einsum("mij,mj->mi", inv[st_in][:, 0:2], w * disp)

    return Statics(
        n_nodes=n, n_cells=c, pos=pos, node_type=nt, face_node=face_node,
        face_type=_face_type(face_node, nt), face_area=face_area,
        face_center=face_center, centroid=centroid, cells_area=cells_area,
        slot_node=ccw.reshape(-1), slot_face=slot_face,
        slot_cell=cell_of, slot_unv=unv,
        st_out=st_out, st_in=st_in, st_w=st_w)
