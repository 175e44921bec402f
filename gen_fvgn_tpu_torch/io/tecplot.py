"""ASCII Tecplot finite-element zone writer (NumPy only).

Counterpart of `gen_fvgn_tpu/io/tecplot.py::write_tecplot_zone` and the
helpers it uses, and of `write_tecplot_async` (the same zone written by a
child process): FETRIANGLE / FEQUADRILATERAL zones for uniform meshes,
FEPOLYGON zones for mixed or polygonal ones, each variable node- or
cell-centred by its length. The file is byte for byte the JAX package's.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, Optional

import numpy as np


def _var_location(values: np.ndarray, n_nodes: int, n_cells: int) -> str:
    if values.shape[0] == n_nodes:
        return "NODAL"
    if values.shape[0] == n_cells:
        return "CELLCENTERED"
    raise ValueError(f"variable of length {values.shape[0]} matches neither "
                     f"nodes ({n_nodes}) nor cells ({n_cells})")


def _block(values: np.ndarray) -> str:
    flat = np.asarray(values, dtype=np.float64).reshape(-1)
    lines = []
    for i in range(0, flat.size, 8):
        lines.append(" ".join(f"{v:.9e}" for v in flat[i:i + 8]))
    return "\n".join(lines)


def write_tecplot_zone(
    path: str,
    pos: np.ndarray,                  # [N, 2]
    cells_node: np.ndarray,           # flat ragged
    cells_index: np.ndarray,
    variables: Dict[str, np.ndarray],  # name -> [N] or [Nc] (or [·, k])
    face_node: Optional[np.ndarray] = None,       # [2, E] (FEPOLYGON only)
    neighbour_cell: Optional[np.ndarray] = None,  # [2, E] (FEPOLYGON only)
    title: str = "gen-fvgn-tpu solution",
    zone_title: str = "zone",
    solution_time: float = 0.0,
) -> None:
    """Write one zone to `path` (directories made as needed). A variable of
    k > 1 columns becomes k scalar columns `name_0` ... A mesh whose cells
    are not all triangles or all quadrilaterals needs `face_node` and
    `neighbour_cell` (an FEPOLYGON zone)."""
    pos = np.asarray(pos, dtype=np.float64)
    cells_node = np.asarray(cells_node).reshape(-1)
    cells_index = np.asarray(cells_index).reshape(-1)
    n_nodes = pos.shape[0]
    n_cells = int(cells_index.max()) + 1

    counts = np.bincount(cells_index, minlength=n_cells)
    uniform = np.unique(counts).size == 1
    cols = [("X", pos[:, 0], "NODAL"), ("Y", pos[:, 1], "NODAL")]
    for name, v in variables.items():
        arr = np.asarray(v).reshape(v.shape[0], -1)
        loc = _var_location(arr, n_nodes, n_cells)
        if arr.shape[1] == 1:
            cols.append((name, arr[:, 0], loc))
        else:
            for c in range(arr.shape[1]):
                cols.append((f"{name}_{c}", arr[:, c], loc))

    var_names = ", ".join(f'"{name}"' for name, _, _ in cols)
    locs = ", ".join(
        f"{i + 1}={loc}" for i, (_, _, loc) in enumerate(cols))

    out = [f'TITLE = "{title}"', f"VARIABLES = {var_names}"]

    if uniform and counts[0] in (3, 4) and face_node is None:
        ztype = "FETRIANGLE" if counts[0] == 3 else "FEQUADRILATERAL"
        out.append(
            f'ZONE T="{zone_title}", N={n_nodes}, E={n_cells}, '
            f"DATAPACKING=BLOCK, ZONETYPE={ztype}, "
            f"VARLOCATION=([{locs}]), SOLUTIONTIME={solution_time}")
        for _, vals, _ in cols:
            out.append(_block(vals))
        conn = cells_node.reshape(n_cells, counts[0]) + 1
        for row in conn:
            out.append(" ".join(str(v) for v in row))
    else:
        if face_node is None or neighbour_cell is None:
            raise ValueError("poly/mixed meshes need face_node and "
                             "neighbour_cell for an FEPOLYGON zone")
        face_node = np.asarray(face_node)
        neighbour_cell = np.asarray(neighbour_cell)
        n_faces = face_node.shape[1]
        out.append(
            f'ZONE T="{zone_title}", ZONETYPE=FEPOLYGON, NODES={n_nodes}, '
            f"ELEMENTS={n_cells}, FACES={n_faces}, "
            f"NumConnectedBoundaryFaces=0, TotalNumBoundaryConnections=0, "
            f"DATAPACKING=BLOCK, VARLOCATION=([{locs}]), "
            f"SOLUTIONTIME={solution_time}")
        for _, vals, _ in cols:
            out.append(_block(vals))
        # face -> node (1-based)
        out.append("\n".join(" ".join(str(v + 1) for v in face_node[:, i])
                             for i in range(n_faces)))
        # left / right elements: a boundary face has 0 on its right
        left, right = neighbour_cell[0], neighbour_cell[1]
        boundary = left == right
        out.append(" ".join(str(v) for v in left + 1))
        out.append(" ".join(str(v) for v in np.where(boundary, 0, right + 1)))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wt") as f:
        f.write("\n".join(out) + "\n")


def write_tecplot_async(path: str, **kwargs) -> subprocess.Popen:
    """`write_tecplot_zone(path, **kwargs)` in a child process, not waited
    for: the arguments are pickled to a temporary file that the child reads
    and deletes. Returns the child (`wait()` on it where the file is
    needed)."""
    import pickle
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as tmp:
        pickle.dump({"path": path, **kwargs}, tmp)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = ("import os, pickle, sys\n"
            "sys.path.insert(0, sys.argv[2])\n"
            "from gen_fvgn_tpu_torch.io.tecplot import write_tecplot_zone\n"
            "with open(sys.argv[1], 'rb') as f:\n"
            "    d = pickle.load(f)\n"
            "os.unlink(sys.argv[1])\n"
            "write_tecplot_zone(**d)\n")
    return subprocess.Popen([sys.executable, "-c", code, tmp.name, root],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
