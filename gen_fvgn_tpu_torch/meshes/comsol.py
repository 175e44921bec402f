"""COMSOL `.mphtxt` mesh reader (host NumPy).

Counterpart of `gen_fvgn_tpu/meshes/comsol.py` (`parse_mphtxt` :79,
`_sort_polygons_ccw`, `_expand_geo_ids`, `assign_node_types` :161-217,
`comsol_to_mesh` :220): a line-cursor parser and vectorised NumPy node
typing, with the same corner priority (inflow → wall → outflow → pressure
point), so both packages read a file into the same arrays.

The `.mphtxt` serialization (for meshes) is a sequence of sections:

    <sdim> # sdim
    <NV> # number of mesh vertices
    <lowest> # lowest mesh vertex index
    # Mesh vertex coordinates
    x y          (NV lines)
    <NT> # number of element types
    per type:
        <len> <name> # type name           (vtx / edg / tri / quad)
        <k> # number of vertices per element
        <NE> # number of elements
        # Elements
        i j ...                            (NE lines)
        <NG> # number of geometric entity indices
        # Geometric entity indices
        g                                  (NG lines)
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import numpy as np

from gen_fvgn_tpu_torch.utils.types import NodeType


class _Cursor:
    """Line cursor over the stripped file contents."""

    def __init__(self, text: str):
        self.lines = [ln.strip() for ln in text.splitlines()]
        self.i = 0

    def seek_comment(self, needle: str) -> None:
        """Advance past the next line whose comment contains `needle`."""
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            self.i += 1
            if needle in ln:
                return
        raise ValueError(f"mphtxt: section {needle!r} not found")

    def int_before_comment(self, needle: str) -> int:
        """Find the next line `<int> # ...needle...` and return the int."""
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            self.i += 1
            if "#" in ln and needle in ln.split("#", 1)[1]:
                return int(ln.split()[0])
        raise ValueError(f"mphtxt: value for {needle!r} not found")

    def data_rows(self, n_rows: int, n_cols: int, dtype) -> np.ndarray:
        """Read `n_rows` rows of `n_cols` whitespace-separated numbers."""
        vals: list = []
        need = n_rows * n_cols
        while len(vals) < need:
            if self.i >= len(self.lines):
                raise ValueError("mphtxt: ran out of data rows")
            ln = self.lines[self.i]
            self.i += 1
            if not ln or ln.startswith("#"):
                continue
            vals.extend(ln.split())
        return np.asarray(vals[:need], dtype=dtype).reshape(n_rows, n_cols)


def parse_mphtxt(path: str) -> Dict[str, dict]:
    """Parse a COMSOL .mphtxt file.

    Returns a dict with:
      "vertices": [NV, sdim] float64
      one entry per element type name ("vtx"/"edg"/"tri"/"quad"), each a dict
      with "elements" [NE, k] int64 (0-based, polygons CCW-sorted) and
      "geo" [NE] int64 geometric-entity ids (1-based, matching the COMSOL GUI,
      parity: parse_comsol.py:339-343).
    """
    with open(path, "rt") as f:
        cur = _Cursor(f.read())

    cur.seek_comment("Object 0")
    sdim = cur.int_before_comment("sdim")
    n_vert = cur.int_before_comment("number of mesh vertices")
    lowest = cur.int_before_comment("lowest mesh vertex index")
    cur.seek_comment("Mesh vertex coordinates")
    vertices = cur.data_rows(n_vert, sdim, np.float64)

    out: Dict[str, dict] = {"vertices": vertices}

    n_types = cur.int_before_comment("number of element types")
    for _ in range(n_types):
        cur.seek_comment("Type #")
        # "<len> <name> # type name"
        while True:
            ln = cur.lines[cur.i]
            cur.i += 1
            if ln and "# type name" in ln:
                name = ln.split("#", 1)[0].split()[1]
                break
        k = cur.int_before_comment("number of vertices per element")
        n_elem = cur.int_before_comment("number of elements")
        cur.seek_comment("# Elements")
        elements = cur.data_rows(n_elem, k, np.int64) - lowest
        n_geo = cur.int_before_comment("number of geometric entity indices")
        cur.seek_comment("Geometric entity indices")
        geo = cur.data_rows(n_geo, 1, np.int64).reshape(-1) + 1  # 1-based GUI ids

        if k > 2 and n_elem > 0:
            elements = _sort_polygons_ccw(vertices, elements)

        out[name] = {"elements": elements, "geo": geo}

    return out


def _sort_polygons_ccw(vertices: np.ndarray, elements: np.ndarray) -> np.ndarray:
    """Reorder each polygon's vertex list counter-clockwise around its centroid.

    Parity: parse_comsol.py:296-304, vectorized over all elements at once.
    """
    coords = vertices[elements]                      # [NE, k, 2]
    center = coords.mean(axis=1, keepdims=True)      # [NE, 1, 2]
    rel = coords - center
    angles = np.arctan2(rel[..., 1], rel[..., 0])    # [NE, k]
    order = np.argsort(angles, axis=1)
    return np.take_along_axis(elements, order, axis=1)


def _expand_geo_ids(raw) -> Optional[list]:
    """Expand BC.json geo-id lists that may contain "7-10" range strings.

    Parity: parse_comsol.py:71-105.
    """
    if raw is None:
        return None
    out: list = []
    stack = list(raw) if isinstance(raw, list) else [raw]
    while stack:
        item = stack.pop(0)
        if isinstance(item, list):
            stack = list(item) + stack
        elif isinstance(item, str) and re.fullmatch(r"\d+-\d+", item):
            a, b = map(int, item.split("-"))
            out.extend(range(a, b + 1))
        else:
            out.append(int(item))
    return out


def assign_node_types(mesh_file: Dict[str, dict], bc: dict) -> tuple:
    """Map BC.json geometric-entity ids onto per-node NodeType codes.

    Returns (node_type [NV] int64, surf_mask [NV] bool).

    Corner-priority semantics match the reference (`set_node_type`,
    parse_comsol.py:348-424): BC groups are applied in the order
    inflow → wall → outflow → pressure_point, with special-cased junction
    nodes (inflow∩wall → IN_WALL; wall/inflow endpoints survive outflow
    assignment).
    """
    n_nodes = mesh_file["vertices"].shape[0]
    node_type = np.full(n_nodes, int(NodeType.NORMAL), dtype=np.int64)
    surf_mask = np.zeros(n_nodes, dtype=bool)

    edg = mesh_file.get("edg")
    if edg is None:
        return node_type, surf_mask
    edge_elems, edge_geo = edg["elements"], edg["geo"]

    def edge_nodes_of(geo_ids):
        sel = np.isin(edge_geo, np.asarray(geo_ids, dtype=np.int64))
        return edge_elems[sel].reshape(-1)

    inflow_ids = _expand_geo_ids(bc.get("inflow"))
    wall_ids = _expand_geo_ids(bc.get("wall"))
    outflow_ids = _expand_geo_ids(bc.get("outflow"))
    press_ids = _expand_geo_ids(bc.get("pressure_point"))
    surf_ids = _expand_geo_ids(bc.get("surf"))

    if inflow_ids:
        node_type[edge_nodes_of(inflow_ids)] = NodeType.INFLOW

    if wall_ids:
        nodes = edge_nodes_of(wall_ids)
        was_inflow = node_type[nodes] == NodeType.INFLOW
        node_type[nodes] = NodeType.WALL_BOUNDARY
        node_type[nodes[was_inflow]] = NodeType.IN_WALL

    if outflow_ids:
        nodes = edge_nodes_of(outflow_ids)
        was_wall = node_type[nodes] == NodeType.WALL_BOUNDARY
        was_inflow = node_type[nodes] == NodeType.INFLOW
        node_type[nodes] = NodeType.OUTFLOW
        node_type[nodes[was_wall]] = NodeType.WALL_BOUNDARY
        node_type[nodes[was_inflow]] = NodeType.INFLOW

    if press_ids and "vtx" in mesh_file:
        vtx_elems = mesh_file["vtx"]["elements"].reshape(-1)
        vtx_geo = mesh_file["vtx"]["geo"]
        sel = np.isin(vtx_geo, np.asarray(press_ids, dtype=np.int64))
        node_type[vtx_elems[sel]] = NodeType.PRESS_POINT

    if surf_ids:
        surf_mask[edge_nodes_of(surf_ids)] = True

    return node_type, surf_mask


def comsol_to_mesh(mphtxt_path: str, bc: Optional[dict] = None) -> dict:
    """Parse a .mphtxt + BC.json pair into the raw mesh dict expected by
    `gen_fvgn_tpu_torch.meshes.geometry.compile_mesh`.

    Returns a dict with keys:
      "node|pos" [N,2], "node|node_type" [N], "node|surf_mask" [N],
      "cells_node" [ΣC_n], "cells_index" [ΣC_n] (flat ragged cell→node pairs).

    Parity: parse_comsol.py `extract_mesh` :455-513 (cells assembly; face
    extraction itself lives in geometry.unique_faces).
    """
    if bc is None:
        bc_path = os.path.join(os.path.dirname(mphtxt_path), "BC.json")
        with open(bc_path, "rt") as f:
            bc = json.load(f)

    mesh_file = parse_mphtxt(mphtxt_path)
    node_type, surf_mask = assign_node_types(mesh_file, bc)

    cells_node_parts = []
    cells_index_parts = []
    count = 0
    for elem_type in ("tri", "quad"):
        if elem_type not in mesh_file:
            continue
        elements = mesh_file[elem_type]["elements"]  # [NE, k]
        ne, k = elements.shape
        cells_node_parts.append(elements.reshape(-1))
        cells_index_parts.append(np.repeat(np.arange(count, count + ne), k))
        count += ne

    if not cells_node_parts:
        raise ValueError(f"{mphtxt_path}: no tri/quad elements found")

    return {
        "node|pos": mesh_file["vertices"].astype(np.float64),
        "node|node_type": node_type,
        "node|surf_mask": surf_mask,
        "cells_node": np.concatenate(cells_node_parts).astype(np.int64),
        "cells_index": np.concatenate(cells_index_parts).astype(np.int64),
    }
