"""Synthetic structured meshes for tests and microbenchmarks.

Generates unit-square quad / tri meshes with lid-driven-cavity-style boundary
types directly in the compiled-mesh dict format (no file I/O), exercising the
same geometric compiler as the real ETL path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
from gen_fvgn_tpu_torch.utils.types import NodeType


def cavity_quad_mesh(n: int = 8, lid: str = "top",
                     press_point: bool = False) -> Dict[str, np.ndarray]:
    """(n+1)×(n+1)-node structured quad mesh on [0,1]²; the lid row is INFLOW,
    the other boundary WALL, lid corners IN_WALL."""
    xs = np.linspace(0.0, 1.0, n + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    pos = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    nid = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)  # [row=y, col=x]

    quads = []
    for j in range(n):
        for i in range(n):
            quads.append([nid[j, i], nid[j, i + 1], nid[j + 1, i + 1],
                          nid[j + 1, i]])
    quads = np.asarray(quads, dtype=np.int64)

    node_type = np.full(pos.shape[0], int(NodeType.NORMAL), dtype=np.int64)
    boundary = ((nid == nid) & False)
    border = np.zeros_like(nid, dtype=bool)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    node_type[nid[border].reshape(-1)] = NodeType.WALL_BOUNDARY
    lid_row = nid[-1, :] if lid == "top" else nid[0, :]
    node_type[lid_row] = NodeType.INFLOW
    node_type[lid_row[0]] = NodeType.IN_WALL
    node_type[lid_row[-1]] = NodeType.IN_WALL
    if press_point:
        node_type[nid[0, 0]] = NodeType.PRESS_POINT

    k = quads.shape[1]
    mesh = {
        "node|pos": pos,
        "node|node_type": node_type,
        "node|surf_mask": np.zeros(pos.shape[0], dtype=bool),
        "cells_node": quads.reshape(-1),
        "cells_index": np.repeat(np.arange(quads.shape[0]), k),
    }
    return compile_mesh(mesh)


def cavity_tri_mesh(n: int = 8, lid: str = "top") -> Dict[str, np.ndarray]:
    """Same cavity split into triangles (each quad → two tris)."""
    quad = cavity_quad_mesh(n, lid)
    # rebuild from scratch: split each quad along a diagonal
    xs = np.linspace(0.0, 1.0, n + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    pos = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    nid = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    tris = []
    for j in range(n):
        for i in range(n):
            a, b0 = nid[j, i], nid[j, i + 1]
            c, d = nid[j + 1, i + 1], nid[j + 1, i]
            tris.append([a, b0, c])
            tris.append([a, c, d])
    tris = np.asarray(tris, dtype=np.int64)
    mesh = {
        "node|pos": pos,
        "node|node_type": quad["node|node_type"],
        "node|surf_mask": np.zeros(pos.shape[0], dtype=bool),
        "cells_node": tris.reshape(-1),
        "cells_index": np.repeat(np.arange(tris.shape[0]), 3),
    }
    return compile_mesh(mesh)


def synthetic_bc(unsteady=0, continuity=0, convection=0, grad_p=0, mu=0.1,
                 source=1.0, u=1.0, sigma=(1.0, 0.0, 0.0), dt=0.1) -> Dict:
    """The physics part of a BC.json with a single coefficient combination
    (Poisson defaults)."""
    return {
        "theta_PDE": {
            "unsteady": unsteady, "continuity": continuity,
            "convection": convection, "grad_p": grad_p,
            "inlet": [u, u, u], "rho": [1, 1, 1], "mu": [mu, mu, mu],
            "source": [source, source, source], "aoa": [0, 0, 0],
            "dt": dt, "L": 1, "Re_max": 1e9, "Re_min": 0,
        },
        "sigma": list(sigma),
        "inlet_type": "uniform",
        "init_field_type": "uniform",
        "stencil|khops": 2,
    }


def synthetic_case(mesh: Dict[str, np.ndarray], unsteady=0, continuity=0,
                   convection=0, grad_p=0, mu=0.1, source=1.0, u=1.0,
                   sigma=(1.0, 0.0, 0.0), dt=0.1, name="synthetic") -> Dict:
    """Wrap a compiled mesh into the case dict the EnvPool consumes, with a
    single-combination BC (`synthetic_bc`)."""
    from gen_fvgn_tpu_torch.meshes.bc import generate_theta_combinations
    bc = synthetic_bc(unsteady, continuity, convection, grad_p, mu, source,
                      u, sigma, dt)
    return {
        "mesh": mesh,
        "bc": bc,
        "combos": generate_theta_combinations(bc["theta_PDE"]),
        "case_name": name,
    }


def wave_case(mesh: Dict[str, np.ndarray], source_frequency=(2.0, 2.0, 2.0),
              source_strength=(5.0, 5.0, 5.0), dt=0.05,
              name="synthetic_wave") -> Dict:
    """Wave-equation case: closed reflecting cavity, zero inlet profile, and
    a Gaussian point pressure source at the domain center injected every
    outer time step (reference Set_BC.py:68-113 + Graph_loader.py:323-363;
    validity rules README.md:188-206: continuity/grad_p/rho > 0,
    convection = mu = source = 0)."""
    from gen_fvgn_tpu_torch.meshes.bc import generate_theta_combinations
    bc = {
        "theta_PDE": {
            "unsteady": 1, "continuity": 1, "convection": 0, "grad_p": 1,
            "inlet": [1, 1, 1], "rho": [1, 1, 1], "mu": [0, 0, 0],
            "source": [0, 0, 0], "aoa": [0, 0, 0],
            "source_frequency": list(source_frequency),
            "source_strength": list(source_strength),
            "dt": dt, "L": 1, "Re_max": 1e9, "Re_min": 0,
        },
        "sigma": [1.0, 1.0, 1.0],
        "inlet_type": None,
        "init_field_type": None,
        "stencil|khops": 2,
    }
    return {
        "mesh": mesh,
        "bc": bc,
        "combos": generate_theta_combinations(bc["theta_PDE"]),
        "case_name": name,
    }
