"""Dependency-free VTK XML writers for 2D hybrid meshes (NumPy only).

Counterpart of `gen_fvgn_tpu/io/vtu.py` (`write_vtu_2d`,
`write_point_cloud_vtu`, `write_vtp_polyline`): ASCII VTK XML, byte for
byte the JAX package's, for tri, quad and polygon cells in the ragged
(cells_node, cells_index) layout.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

_VTK_TRI = 5
_VTK_POLY = 7
_VTK_QUAD = 9


def _da(name: str, arr: np.ndarray, n_comp: int) -> str:
    flat = np.asarray(arr, dtype=np.float64).reshape(-1)
    body = " ".join(f"{v:.9g}" for v in flat)
    return (f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{n_comp}" format="ascii">{body}</DataArray>')


def _ia(name: str, arr: np.ndarray) -> str:
    body = " ".join(str(int(v)) for v in np.asarray(arr).reshape(-1))
    return (f'<DataArray type="Int64" Name="{name}" '
            f'format="ascii">{body}</DataArray>')


def _fields_xml(data: Optional[Dict[str, np.ndarray]], n_expected: int) -> str:
    if not data:
        return ""
    parts = []
    for key, arr in data.items():
        a = np.asarray(arr)
        if a.shape[0] != n_expected:
            continue
        n_comp = 1 if a.ndim == 1 else a.shape[1]
        parts.append(_da(key.split("|")[-1], a, n_comp))
    return "".join(parts)


def write_vtu_2d(path: str, pos: np.ndarray, cells_node: np.ndarray,
                 cells_index: np.ndarray,
                 point_data: Optional[Dict[str, np.ndarray]] = None,
                 cell_data: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write an unstructured 2D mesh (ragged cells) with point/cell fields."""
    pos = np.asarray(pos, dtype=np.float64)
    cells_node = np.asarray(cells_node).reshape(-1)
    cells_index = np.asarray(cells_index).reshape(-1)
    n_points = pos.shape[0]
    n_cells = int(cells_index.max()) + 1 if cells_index.size else 0

    counts = np.bincount(cells_index, minlength=n_cells)
    offsets = np.cumsum(counts)
    types = np.where(counts == 3, _VTK_TRI,
                     np.where(counts == 4, _VTK_QUAD, _VTK_POLY))

    # connectivity must be grouped by cell id in ascending order
    order = np.argsort(cells_index, kind="stable")
    connectivity = cells_node[order]

    xyz = np.concatenate([pos, np.zeros((n_points, 1))], axis=1)
    xml = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{n_points}" NumberOfCells="{n_cells}">',
        "<Points>", _da("Points", xyz, 3), "</Points>",
        "<Cells>",
        _ia("connectivity", connectivity),
        _ia("offsets", offsets),
        _ia("types", types),
        "</Cells>",
        "<PointData>", _fields_xml(point_data, n_points), "</PointData>",
        "<CellData>", _fields_xml(cell_data, n_cells), "</CellData>",
        "</Piece>", "</UnstructuredGrid>", "</VTKFile>",
    ]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wt") as f:
        f.write("\n".join(xml))


def write_point_cloud_vtu(path: str, pos: np.ndarray,
                          point_data: Optional[Dict[str, np.ndarray]] = None
                          ) -> None:
    """Point cloud as VTU with VTK_VERTEX cells (debug artifacts like the
    reference's face_type_in_scatter.vtu, parse_to_h5.py:372-375)."""
    pos = np.asarray(pos, dtype=np.float64)
    if pos.shape[1] == 2:
        pos = np.concatenate([pos, np.zeros((pos.shape[0], 1))], axis=1)
    n = pos.shape[0]
    xml = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{n}" NumberOfCells="{n}">',
        "<Points>", _da("Points", pos, 3), "</Points>",
        "<Cells>",
        _ia("connectivity", np.arange(n)),
        _ia("offsets", np.arange(1, n + 1)),
        _ia("types", np.full(n, 1)),  # VTK_VERTEX
        "</Cells>",
        "<PointData>", _fields_xml(point_data, n), "</PointData>",
        "<CellData></CellData>",
        "</Piece>", "</UnstructuredGrid>", "</VTKFile>",
    ]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wt") as f:
        f.write("\n".join(xml))


def write_vtp_polyline(path: str, pos: np.ndarray, edge_index: np.ndarray
                       ) -> None:
    """Boundary edges as a PolyData lines file (debug artifact `surf_edge.vtp`,
    parse_comsol.py:499-503)."""
    pos = np.asarray(pos, dtype=np.float64)
    if pos.shape[1] == 2:
        pos = np.concatenate([pos, np.zeros((pos.shape[0], 1))], axis=1)
    edges = np.asarray(edge_index)
    n_lines = edges.shape[1]
    xml = [
        '<?xml version="1.0"?>',
        '<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian">',
        "<PolyData>",
        f'<Piece NumberOfPoints="{pos.shape[0]}" NumberOfLines="{n_lines}">',
        "<Points>", _da("Points", pos, 3), "</Points>",
        "<Lines>",
        _ia("connectivity", edges.T),
        _ia("offsets", np.arange(2, 2 * n_lines + 1, 2)),
        "</Lines>",
        "</Piece>", "</PolyData>", "</VTKFile>",
    ]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wt") as f:
        f.write("\n".join(xml))
