"""Per-case .h5 mesh files.

Counterpart of `gen_fvgn_tpu/meshes/hdf5.py` (`write_mesh_h5`,
`read_mesh_h5`), with the same on-disk schema: one group per case, keys
such as "node|pos", "face|face_node", "cells_node". h5py is imported inside
each function, so the package imports on a machine without it; there
either function raises an ImportError that names the file.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _h5py(path: str):
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            f"{path}: .h5 mesh files need h5py, which is not installed; "
            f"remove the .h5 to read the case's .mphtxt or .dat mesh, or "
            f"install h5py") from exc
    return h5py


def write_mesh_h5(mesh: Dict[str, np.ndarray], path: str,
                  case_name: str) -> None:
    h5py = _h5py(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        grp = f.create_group(case_name)
        for key, value in mesh.items():
            if not isinstance(value, np.ndarray):
                continue
            grp.create_dataset(key, data=value)


def read_mesh_h5(path: str) -> Dict[str, np.ndarray]:
    h5py = _h5py(path)
    with h5py.File(path, "r") as f:
        case = list(f.keys())[0]
        grp = f[case]
        mesh = {key: np.asarray(grp[key][()]) for key in grp.keys()}
    mesh["case_name"] = case
    return mesh
