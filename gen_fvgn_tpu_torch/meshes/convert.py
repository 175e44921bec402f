"""Offline mesh conversion: raw meshes + BC.json → per-case .h5.

Counterpart of `gen_fvgn_tpu/meshes/convert.py` (`convert_case` :26,
`find_meshes` :74, `main` :85): walk a dataset directory, convert every
COMSOL `.mphtxt` / Tecplot `.dat` mesh with its sibling BC.json, write
`<case>.h5` plus the debug artifacts (`node_type_with_mesh.vtu`,
`face_type_in_scatter.vtu`, `surf_edge.vtp`) for visual BC verification,
in a process pool. Writing `.h5` needs h5py.

Usage:
    python -m gen_fvgn_tpu_torch.meshes.convert --dir <dataset_dir> [--workers N]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Optional

import numpy as np

from gen_fvgn_tpu_torch.io.vtu import (write_point_cloud_vtu,
                                       write_vtp_polyline, write_vtu_2d)
from gen_fvgn_tpu_torch.meshes.comsol import comsol_to_mesh
from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
from gen_fvgn_tpu_torch.meshes.hdf5 import write_mesh_h5
from gen_fvgn_tpu_torch.meshes.tecplot import tecplot_to_mesh


def convert_case(mesh_path: str, out_dir: Optional[str] = None,
                 write_debug_artifacts: bool = True) -> str:
    """Convert one mesh file (+ sibling BC.json) to <case>.h5. Returns the
    h5 path."""
    case_dir = os.path.dirname(os.path.abspath(mesh_path))
    case_name = os.path.basename(case_dir)
    out_dir = out_dir or case_dir

    if mesh_path.endswith(".mphtxt"):
        raw = comsol_to_mesh(mesh_path)
    elif mesh_path.endswith(".dat"):
        raw = tecplot_to_mesh(mesh_path, case_name)
    else:
        raise ValueError(f"unsupported mesh format: {mesh_path}")

    mesh = compile_mesh(raw)
    h5_path = os.path.join(out_dir, f"{case_name}.h5")
    write_mesh_h5(mesh, h5_path, case_name)

    if write_debug_artifacts:
        write_vtu_2d(os.path.join(out_dir, "node_type_with_mesh.vtu"),
                     mesh["node|pos"], mesh["cells_node"],
                     mesh["cells_index"],
                     point_data={"node_type":
                                 mesh["node|node_type"].astype(float)})
        write_point_cloud_vtu(
            os.path.join(out_dir, "face_type_in_scatter.vtu"),
            mesh["face|face_center_pos"],
            {"face_type": mesh["face|face_type"].astype(float)})
        surf = mesh["node|surf_mask"].reshape(-1)
        if surf.any():
            fn = mesh["face|face_node"]
            keep = surf[fn[0]] & surf[fn[1]]
            # re-index onto the surface point subset
            remap = np.full(surf.shape[0], -1, dtype=np.int64)
            remap[np.flatnonzero(surf)] = np.arange(int(surf.sum()))
            write_vtp_polyline(os.path.join(out_dir, "surf_edge.vtp"),
                               mesh["node|pos"][surf], remap[fn[:, keep]])
    return h5_path


def find_meshes(root: str):
    out = []
    for subdir, _, files in os.walk(root):
        if not os.path.exists(os.path.join(subdir, "BC.json")):
            continue
        for f in files:
            if f.endswith((".mphtxt", ".dat")):
                out.append(os.path.join(subdir, f))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True, help="dataset root to walk")
    ap.add_argument("--out", default=None, help="output root (default: in place)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--no-debug-artifacts", action="store_true")
    args = ap.parse_args(argv)

    meshes = find_meshes(args.dir)
    print(f"converting {len(meshes)} meshes under {args.dir}")
    if args.workers <= 1 or len(meshes) <= 1:
        for m in meshes:
            print("  ", convert_case(m, args.out,
                                     not args.no_debug_artifacts))
        return
    with ProcessPoolExecutor(max_workers=args.workers,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        futures = {pool.submit(convert_case, m, args.out,
                               not args.no_debug_artifacts): m
                   for m in meshes}
        for fut in as_completed(futures):
            print("  ", fut.result())


if __name__ == "__main__":
    main()
