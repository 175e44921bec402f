"""Boundary-zone extraction for post-processing / force evaluation.

Counterpart of `gen_fvgn_tpu/meshes/boundary.py` (`filter_subgraph`,
`extract_boundary_zone`), after the reference `src/utils/utilities.py`
`generate_boundary_zone` :130-156 and `filter_adj` :159-177: restrict the
face graph to the obstacle-surface node subset and re-index, producing the
surface polyline zone exported with solutions (used for obstacle
force/traction post-processing).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def filter_subgraph(edge_index: np.ndarray, keep_mask: np.ndarray):
    """Re-index edges onto the kept-node subset; returns (edges [2, E'],
    edge_keep_mask [E])."""
    remap = np.full(keep_mask.shape[0], -1, dtype=np.int64)
    remap[np.flatnonzero(keep_mask)] = np.arange(int(keep_mask.sum()))
    row, col = remap[edge_index[0]], remap[edge_index[1]]
    valid = (row >= 0) & (col >= 0)
    return np.stack([row[valid], col[valid]], axis=0), valid


def extract_boundary_zone(mesh: Dict[str, np.ndarray],
                          rho: Optional[float] = None,
                          mu: Optional[float] = None,
                          dt: Optional[float] = None) -> Optional[dict]:
    """Surface (obstacle) zone of a compiled mesh, or None when the mesh has
    no surf-marked nodes."""
    surf = np.asarray(mesh.get("node|surf_mask")).reshape(-1)
    if surf is None or not surf.any():
        return None
    face_node = np.asarray(mesh["face|face_node"])
    pos = np.asarray(mesh["node|pos"])
    surf_edges, edge_mask = filter_subgraph(face_node, surf)
    return {
        "name": "OBSTACLE",
        "zonename": "OBSTICALE_BOUNDARY",
        "rho": rho, "mu": mu, "dt": dt,
        "node|surf_mask": surf,
        "face|surf_face_mask": edge_mask,
        "face|face_node": surf_edges,
        "node|mesh_pos": pos[surf],
    }
