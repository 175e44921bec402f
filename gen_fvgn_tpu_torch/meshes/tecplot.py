"""Tecplot FEPolygon `.dat` mesh reader (host NumPy).

Counterpart of `gen_fvgn_tpu/meshes/tecplot.py` (`parse_tecplot_dat` :121,
`_assemble_polygon_cells` :88, `assign_pipe_flow_types` :162,
`tecplot_to_mesh` :203):

* the interior FEPolygon zone yields node coordinates, face→node pairs and
  left/right elements; cells are reassembled from face incidence with one
  lexsort per ragged array (the reference loops per cell in Python);
* FELineSeg zones contribute their node positions to the boundary point set;
* boundary types are assigned GEOMETRICALLY for pipe flow (x-min inflow,
  y-extremes wall, x-max outflow, interior boundary-zone points = obstacle
  surface) — only "cylinder" pipe-flow cases are supported, like the
  reference (:646-652).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from gen_fvgn_tpu_torch.utils.types import NodeType


def _tokenize_zones(path: str) -> List[dict]:
    """Split the file into zones: each with header dict, data block floats,
    and named int sections (# face nodes / # left elements / ...)."""
    zones: List[dict] = []
    current: Optional[dict] = None
    variables: List[str] = []
    section: Optional[str] = None
    header_mode = False

    with open(path, "rt") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("TITLE"):
                continue
            if line.startswith("VARIABLES"):
                variables = re.findall(r'"([^"]+)"', line)
                continue
            if line.startswith('"'):
                variables += re.findall(r'"([^"]+)"', line)
                continue
            if line.startswith("ZONE"):
                current = {"header": {}, "data": [], "sections": {},
                           "variables": list(variables)}
                zones.append(current)
                header_mode = True
                section = None
                _parse_header_items(line[4:], current["header"])
                m = re.search(r'T\s*=\s*"([^"]+)"', line)
                if m:
                    current["header"]["T"] = m.group(1)
                continue
            if current is None:
                continue
            if header_mode:
                if any(line.lstrip().startswith(k) for k in
                       ("STRANDID", "SOLUTIONTIME", "Nodes", "Faces",
                        "Elements", "ZONETYPE", "DATAPACKING",
                        "NumConnected", "TotalNum", "DT=", "DT =", "DT=(")) \
                        or line.startswith("DT"):
                    _parse_header_items(line, current["header"])
                    continue
                header_mode = False  # first data line
            if line.startswith("#"):
                section = "_".join(line.lstrip("#").strip().split())
                current["sections"][section] = []
                continue
            target = (current["sections"][section] if section is not None
                      else current["data"])
            target.extend(line.split())
    return zones


def _parse_header_items(text: str, header: dict) -> None:
    for item in text.split(","):
        if "=" in item:
            key, _, value = item.partition("=")
            header[key.strip()] = value.strip().strip('"')


def _assemble_polygon_cells(face_node: np.ndarray, left: np.ndarray,
                            right: np.ndarray, pos: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(cells_node, cells_index) flat ragged arrays with contiguous CCW slots
    per cell, from face→cell adjacency. Vectorized via lexsort."""
    n_faces = face_node.shape[1]
    face_ids = np.arange(n_faces)
    # incidences (cell, face); Tecplot boundary outside = 0 → drop
    inc_cell = np.concatenate([left, right]) - 1
    inc_face = np.concatenate([face_ids, face_ids])
    keep = inc_cell >= 0
    inc_cell, inc_face = inc_cell[keep], inc_face[keep]
    n_cells = int(inc_cell.max()) + 1

    face_center = 0.5 * (pos[face_node[0]] + pos[face_node[1]])
    centroid = np.zeros((n_cells, 2))
    np.add.at(centroid, inc_cell, face_center[inc_face])
    cnt = np.bincount(inc_cell, minlength=n_cells).astype(np.float64)
    centroid /= np.maximum(cnt, 1.0)[:, None]

    # (cell, node) incidences, deduplicated
    cn_cell = np.concatenate([inc_cell, inc_cell])
    cn_node = np.concatenate([face_node[0][inc_face], face_node[1][inc_face]])
    key = cn_cell.astype(np.int64) * pos.shape[0] + cn_node
    _, first = np.unique(key, return_index=True)
    cn_cell, cn_node = cn_cell[first], cn_node[first]

    rel = pos[cn_node] - centroid[cn_cell]
    angle = np.arctan2(rel[:, 1], rel[:, 0])
    order = np.lexsort((angle, cn_cell))
    return cn_node[order].astype(np.int64), cn_cell[order].astype(np.int64)


def parse_tecplot_dat(path: str) -> Dict[str, np.ndarray]:
    """Parse the interior FEPolygon zone + boundary FELineSeg zones.

    Returns {"node|pos" [N,2], "cells_node", "cells_index",
             "boundary_pos" [Nb,2] (all boundary-zone points)}.
    """
    zones = _tokenize_zones(path)
    interior = None
    boundary_pos = []
    for z in zones:
        ztype = z["header"].get("ZONETYPE", "").lower()
        n_nodes = int(z["header"].get("Nodes", 0))
        nvars = max(len(z["variables"]), 2)
        data = np.asarray(z["data"][: n_nodes * nvars], dtype=np.float64)
        groups = data.reshape(nvars, n_nodes)
        pos = np.stack([groups[0], groups[1]], axis=1)
        if ztype == "fepolygon":
            interior = (z, pos)
        elif ztype == "felineseg":
            boundary_pos.append(pos)

    if interior is None:
        raise ValueError(f"{path}: no FEPolygon zone found")
    z, pos = interior
    fn = np.asarray(z["sections"]["face_nodes"], dtype=np.int64)
    face_node = fn.reshape(-1, 2).T - 1
    left = np.asarray(z["sections"]["left_elements"], dtype=np.int64)
    right = np.asarray(z["sections"]["right_elements"], dtype=np.int64)

    cells_node, cells_index = _assemble_polygon_cells(
        face_node, left, right, pos)

    return {
        "node|pos": pos,
        "cells_node": cells_node,
        "cells_index": cells_index,
        "boundary_pos": (np.concatenate(boundary_pos, axis=0)
                         if boundary_pos else np.zeros((0, 2))),
    }


def assign_pipe_flow_types(pos: np.ndarray, boundary_pos: np.ndarray,
                           tol: float = 1e-8
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Geometric boundary typing for pipe flow around an obstacle:
    x-min (excl. corners) INFLOW, y-extremes WALL, x-max OUTFLOW, interior
    boundary-zone points WALL + surf (obstacle). Vectorized equivalent of the
    reference's per-node loop (parse_tecplot.py:565-637)."""
    shifted = pos - pos.min(axis=0, keepdims=True)
    b_shifted = boundary_pos - pos.min(axis=0, keepdims=True)
    x, y = shifted[:, 0], shifted[:, 1]
    top, bottom = y.max(), y.min()
    outlet, inlet = x.max(), x.min()
    eps = 1e-12

    node_type = np.full(pos.shape[0], int(NodeType.NORMAL), dtype=np.int64)
    surf_mask = np.zeros(pos.shape[0], dtype=bool)

    is_inlet = (np.abs(x - inlet) < tol) & (y > bottom + eps) & (y < top - eps)
    is_wall_span = (y >= top - eps) | (y <= bottom + eps)
    is_outlet = (np.abs(x - outlet) < tol) & (y > bottom + eps) & (y < top - eps)

    # obstacle: exact membership in the boundary point set, interior only
    if b_shifted.shape[0]:
        view = {(round(float(px), 12), round(float(py), 12))
                for px, py in b_shifted}
        on_bnd = np.asarray(
            [(round(float(px), 12), round(float(py), 12)) in view
             for px, py in shifted])
    else:
        on_bnd = np.zeros(pos.shape[0], dtype=bool)
    is_obstacle = (on_bnd & (x > 0) & (x < outlet - eps) &
                   (y > 0) & (y < top - eps))

    node_type[is_inlet] = NodeType.INFLOW
    node_type[is_wall_span] = NodeType.WALL_BOUNDARY
    node_type[is_outlet] = NodeType.OUTFLOW
    node_type[is_obstacle] = NodeType.WALL_BOUNDARY
    surf_mask[is_obstacle] = True
    return node_type, surf_mask


def tecplot_to_mesh(dat_path: str, case_name: str = "cylinder") -> dict:
    """Full raw-mesh assembly for a pipe-flow polygon case (feeds
    geometry.compile_mesh)."""
    if "cylinder" not in case_name:
        raise ValueError("only pipe-flow 'cylinder' cases are supported for "
                         "Tecplot meshes (parity: parse_tecplot.py:646-652)")
    parsed = parse_tecplot_dat(dat_path)
    node_type, surf_mask = assign_pipe_flow_types(
        parsed["node|pos"], parsed["boundary_pos"])
    return {
        "node|pos": parsed["node|pos"],
        "node|node_type": node_type,
        "node|surf_mask": surf_mask,
        "cells_node": parsed["cells_node"],
        "cells_index": parsed["cells_index"],
    }
