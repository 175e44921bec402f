"""Case directories on disk: a mesh file and its BC.json.

    from gen_fvgn_tpu_torch.tools.case_files import (write_cavity_case,
                                                     write_cylinder_case)
    write_cavity_case("data/cavity", n=100, kind="quad")    # 101x101 nodes

Writes the unit-square cavity as a COMSOL `.mphtxt` (quadrilaterals,
triangles, or both) and a pipe-flow channel around a square obstacle as a
Tecplot `.dat` in the reference's zone layout (an FEPolygon interior zone
with `# face nodes` / `# left elements` / `# right elements`, FELineSeg
boundary zones), each with a BC.json, so that `training/pool.py::
load_case`, the CLIs and `meshes/convert.py` can read them. It writes no
`.h5`: that is `meshes/convert.py`'s job, and it needs h5py.

Geometric entities of the cavity, in COMSOL's 1-based numbering: edges 1
bottom (y = 0), 2 left (x = 0), 3 top (y = 1), 4 right (x = 1); vertices
1 (0, 0), 2 (0, 1), 3 (1, 0), 4 (1, 1). `boundary="lid"` makes the top
edge the inflow and the others walls (the lid-driven cavity);
`boundary="channel"` makes the left edge the inflow, the right edge the
outflow and the others walls.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from gen_fvgn_tpu_torch.meshes.synthetic import synthetic_bc

_GEO = {"lid": {"inflow": [3], "wall": [1, 2, 4], "outflow": []},
        "channel": {"inflow": [2], "wall": [1, 3], "outflow": [4]}}


def _num(v) -> str:
    return repr(float(v))


def cavity_elements(n: int, kind: str = "quad"):
    """(pos [(n+1)², 2], {"tri": [T, 3], "quad": [Q, 4]}) of the unit square
    cut into n x n cells: "quad" cells, "tri" (each cell split along its
    diagonal) or "mixed" (cells with an even index split). Quadrilaterals
    are listed in COMSOL's node order (not counter-clockwise): the reader
    sorts them."""
    xs = np.linspace(0.0, 1.0, n + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    pos = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    nid = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)      # [y, x]
    a, b = nid[:-1, :-1].reshape(-1), nid[:-1, 1:].reshape(-1)
    c, d = nid[1:, 1:].reshape(-1), nid[1:, :-1].reshape(-1)
    split = {"quad": np.zeros(a.size, bool), "tri": np.ones(a.size, bool),
             "mixed": np.arange(a.size) % 2 == 0}[kind]
    tris = np.concatenate([np.stack([a, b, c], 1)[split],
                           np.stack([a, c, d], 1)[split]])
    quads = np.stack([a, b, d, c], 1)[~split]
    out = {}
    if tris.size:
        out["tri"] = tris
    if quads.size:
        out["quad"] = quads
    return pos, out


def write_mphtxt(path: str, pos: np.ndarray,
                 types: Dict[str, tuple]) -> None:
    """A COMSOL `.mphtxt` mesh: vertex coordinates, then per element type
    (name -> (elements [E, k] 0-based, geometric entity indices [E]
    0-based)) its elements and entity indices."""
    out = ["# Created by gen_fvgn_tpu_torch.tools.case_files", "",
           "# Major & minor version", "0 1", "1 # number of tags", "# Tags",
           "5 mesh1", "1 # number of types", "# Types", "3 obj", "",
           "# --------- Object 0 ----------", "", "0 0 1", "4 Mesh # class",
           "4 # version", "2 # sdim",
           f"{pos.shape[0]} # number of mesh vertices",
           "0 # lowest mesh vertex index", "", "# Mesh vertex coordinates"]
    out += [f"{_num(x)} {_num(y)}" for x, y in pos]
    out += ["", f"{len(types)} # number of element types", ""]
    for t, (name, (elements, geo)) in enumerate(types.items()):
        out += [f"# Type #{t}", "", f"{len(name)} {name} # type name", "",
                "", f"{elements.shape[1]} # number of vertices per element",
                f"{elements.shape[0]} # number of elements", "# Elements"]
        out += [" ".join(str(int(v)) for v in row) for row in elements]
        out += ["", f"{geo.shape[0]} # number of geometric entity indices",
                "# Geometric entity indices"]
        out += [str(int(g)) for g in geo]
        out += [""]
    with open(path, "wt") as f:
        f.write("\n".join(out) + "\n")


def _cavity_boundary(n: int):
    """The cavity's boundary segments and corner vertices with their
    0-based geometric entity indices (bottom 0, left 1, top 2, right 3;
    corners (0,0) 0, (0,1) 1, (1,0) 2, (1,1) 3)."""
    nid = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    sides = [nid[0, :], nid[:, 0], nid[-1, :], nid[:, -1]]
    edg = np.concatenate([np.stack([s[:-1], s[1:]], 1) for s in sides])
    edg_geo = np.repeat(np.arange(4), n)
    vtx = np.asarray([[nid[0, 0]], [nid[-1, 0]], [nid[0, -1]],
                      [nid[-1, -1]]])
    return edg, edg_geo, vtx, np.arange(4)


def write_cavity_case(case_dir: str, n: int = 100, kind: str = "quad",
                      boundary: str = "lid", bc: Optional[dict] = None,
                      pressure_point: Optional[int] = None) -> str:
    """Write `<case_dir>/mesh.mphtxt` (the (n+1)x(n+1)-node unit square,
    `cavity_elements(n, kind)`) and `<case_dir>/BC.json`: the geometric
    entities of `boundary` ("lid" or "channel"), `pressure_point` (a
    1-based corner vertex, or none) and the physics of `bc` (default:
    `synthetic_bc` of a Navier-Stokes flow, mu 0.05). Returns case_dir."""
    os.makedirs(case_dir, exist_ok=True)
    pos, cells = cavity_elements(n, kind)
    edg, edg_geo, vtx, vtx_geo = _cavity_boundary(n)
    types = {"vtx": (vtx, vtx_geo), "edg": (edg, edg_geo)}
    types.update({name: (el, np.zeros(el.shape[0], np.int64))
                  for name, el in cells.items()})
    write_mphtxt(os.path.join(case_dir, "mesh.mphtxt"), pos, types)
    bc = dict(bc if bc is not None else synthetic_bc(
        continuity=1, convection=1, grad_p=1, mu=0.05, sigma=(1, 1, 1)))
    bc.update(_GEO[boundary])
    bc["pressure_point"] = [] if pressure_point is None else [pressure_point]
    with open(os.path.join(case_dir, "BC.json"), "wt") as f:
        json.dump(bc, f, indent=1)
    return case_dir


def _zone_block(values: np.ndarray) -> list:
    flat = np.asarray(values, np.float64).reshape(-1)
    return [" ".join(_num(v) for v in flat[i:i + 8])
            for i in range(0, flat.size, 8)]


def write_cylinder_case(case_dir: str, nx: int = 22, ny: int = 8,
                        obstacle=(6, 9, 3, 5), bc: Optional[dict] = None
                        ) -> str:
    """Write `<case_dir>/mesh.dat`, a pipe-flow channel [0, 2.2] x [0,
    0.41] of nx x ny quadrilateral cells with the cells (i, j), i0 <= i <
    i1, j0 <= j < j1 of `obstacle` (i0, i1, j0, j1) cut out, and
    `<case_dir>/BC.json` (default physics: `synthetic_bc` of a
    Navier-Stokes flow with a parabolic inlet). The Tecplot reader takes
    only pipe-flow cases whose directory name holds "cylinder". Returns
    case_dir."""
    os.makedirs(case_dir, exist_ok=True)
    xs, ys = np.linspace(0.0, 2.2, nx + 1), np.linspace(0.0, 0.41, ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    pos = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    nid = np.arange(pos.shape[0]).reshape(ny + 1, nx + 1)
    i0, i1, j0, j1 = obstacle
    cells = [[nid[j, i], nid[j, i + 1], nid[j + 1, i + 1], nid[j + 1, i]]
             for j in range(ny) for i in range(nx)
             if not (i0 <= i < i1 and j0 <= j < j1)]
    cells = np.asarray(cells, np.int64)
    used = np.unique(cells)
    remap = np.full(pos.shape[0], -1, np.int64)
    remap[used] = np.arange(used.size)
    pos, cells = pos[used], remap[cells]
    # faces: each cell side once, with the cells on its two sides (1-based,
    # 0 outside the domain)
    sides = np.stack([cells, np.roll(cells, -1, axis=1)], -1).reshape(-1, 2)
    owner = np.repeat(np.arange(cells.shape[0]), 4) + 1
    key = np.sort(sides, axis=1)
    uniq, first, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    inv = inv.reshape(-1)
    left = owner[first]
    right = np.zeros(uniq.shape[0], np.int64)
    second = np.flatnonzero(np.arange(inv.size) != first[inv])
    right[inv[second]] = owner[second]
    face_node = sides[first] + 1
    # the obstacle's boundary loop, as a line-segment zone
    ring = [nid[j0, i] for i in range(i0, i1 + 1)] + \
        [nid[j, i1] for j in range(j0 + 1, j1 + 1)] + \
        [nid[j1, i] for i in range(i1 - 1, i0 - 1, -1)] + \
        [nid[j, i0] for j in range(j1 - 1, j0, -1)]
    ring = remap[np.asarray(ring)]
    out = ['TITLE = "pipe flow"', 'VARIABLES = "X"', '"Y"',
           'ZONE T="fluid"', " STRANDID=0, SOLUTIONTIME=0",
           f" Nodes={pos.shape[0]}, Faces={uniq.shape[0]}, "
           f"Elements={cells.shape[0]}, ZONETYPE=FEPolygon",
           " NumConnectedBoundaryFaces=0, TotalNumBoundaryConnections=0",
           " DATAPACKING=BLOCK", " DT=(SINGLE SINGLE )"]
    out += _zone_block(pos[:, 0]) + _zone_block(pos[:, 1])
    out += ["# face nodes"] + [f"{a} {b}" for a, b in face_node]
    out += ["# left elements"] + [" ".join(map(str, left))]
    out += ["# right elements"] + [" ".join(map(str, right))]
    out += ['ZONE T="cylinder"', " STRANDID=0, SOLUTIONTIME=0",
            f" Nodes={ring.size}, Elements={ring.size}, ZONETYPE=FELineSeg",
            " DATAPACKING=BLOCK", " DT=(SINGLE SINGLE )"]
    out += _zone_block(pos[ring, 0]) + _zone_block(pos[ring, 1])
    out += [f"{k + 1} {(k + 1) % ring.size + 1}" for k in range(ring.size)]
    with open(os.path.join(case_dir, "mesh.dat"), "wt") as f:
        f.write("\n".join(out) + "\n")
    if bc is None:
        bc = synthetic_bc(continuity=1, convection=1, grad_p=1, mu=0.01,
                          sigma=(1, 1, 1))
        bc["inlet_type"] = "parabolic"
    with open(os.path.join(case_dir, "BC.json"), "wt") as f:
        json.dump(bc, f, indent=1)
    return case_dir
