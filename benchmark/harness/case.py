"""The benchmark's own case writer: a raw mesh (`reference.mesh.RawMesh`)
as a COMSOL `.mphtxt` beside its `BC.json`, the files the system's
`load_case` reads.

A frozen copy of the pattern of the system's `tools/case_files.py`:
vertex coordinates; vertex, edge and quadrilateral elements with their
geometric entity indices (0-based in the file; `BC.json` names them
1-based). The cavity's entities: edges 1 bottom, 2 left, 3 top, 4 right.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from benchmark.reference.mesh import INFLOW, OUTFLOW, WALL, RawMesh


def _num(v) -> str:
    return repr(float(v))


def _entities(m: RawMesh) -> np.ndarray:
    """0-based entity index of each boundary segment: consecutive runs of
    one kind and direction form one entity (the cavity's four sides)."""
    d = m.pos[m.seg[:, 1]] - m.pos[m.seg[:, 0]]
    key = list(zip(m.seg_kind.tolist(), np.sign(d[:, 0]).tolist(),
                   np.sign(d[:, 1]).tolist()))
    ent, cur = np.zeros(len(key), np.int64), 0
    for i in range(1, len(key)):
        cur += key[i] != key[i - 1]
        ent[i] = cur
    return ent


def write_case(case_dir: str, m: RawMesh, bc: Dict) -> str:
    """Write `<case_dir>/mesh.mphtxt` and `<case_dir>/BC.json` (the physics
    of `bc`, the boundary entities of the mesh's segments)."""
    os.makedirs(case_dir, exist_ok=True)
    ent = _entities(m)
    types = {"edg": (m.seg, ent),
             "quad": (m.cells[:, [0, 1, 3, 2]],
                      np.zeros(m.cells.shape[0], np.int64))}
    out = ["# Created by the benchmark's case writer", "",
           "# Major & minor version", "0 1", "1 # number of tags", "# Tags",
           "5 mesh1", "1 # number of types", "# Types", "3 obj", "",
           "# --------- Object 0 ----------", "", "0 0 1", "4 Mesh # class",
           "4 # version", "2 # sdim",
           f"{m.pos.shape[0]} # number of mesh vertices",
           "0 # lowest mesh vertex index", "", "# Mesh vertex coordinates"]
    out += [f"{_num(x)} {_num(y)}" for x, y in m.pos]
    out += ["", f"{len(types)} # number of element types", ""]
    for t, (name, (el, geo)) in enumerate(types.items()):
        out += [f"# Type #{t}", "", f"{len(name)} {name} # type name", "",
                "", f"{el.shape[1]} # number of vertices per element",
                f"{el.shape[0]} # number of elements", "# Elements"]
        out += [" ".join(str(int(v)) for v in row) for row in el]
        out += ["", f"{geo.shape[0]} # number of geometric entity indices",
                "# Geometric entity indices"]
        out += [str(int(g)) for g in geo] + [""]
    with open(os.path.join(case_dir, "mesh.mphtxt"), "wt") as f:
        f.write("\n".join(out) + "\n")
    groups = {"inflow": INFLOW, "wall": WALL, "outflow": OUTFLOW}
    full = dict(bc)
    for key, kind in groups.items():
        full[key] = sorted({int(e) + 1 for e in ent[m.seg_kind == kind]})
    full["pressure_point"] = []
    with open(os.path.join(case_dir, "BC.json"), "wt") as f:
        json.dump(full, f, indent=1)
    return case_dir
