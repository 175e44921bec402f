"""Common-criterion mass imbalance: the solver-comparison functional.

Counterpart of `gen_fvgn_tpu/fv/mass.py` (NumPy on the host, as there).

The reference's headline compares learned-solver iterations against a
traditional CFD solver's (README.md:10). Iteration counts are only
comparable under a COMMON convergence criterion, but each scheme satisfies
discrete continuity on its OWN flux definition (the framework: node-mean
face fluxes, fv/integrator.py; SIMPLE: Rhie-Chow cell-face fluxes), so any
single flux evaluation applied to the other scheme's field floors at the
O(h²) inter-scheme interpolation error long before convergence (measured:
docs_assets_simple_cylinder_re100.json `framework_cont_floor`).

The standard CFD-practice resolution, used here: the IDENTICAL statistic —

    mass_l1_rel = Σ_cells |net volumetric face flux| / Q_in

with the same normalization (inlet volumetric flow) and the same threshold,
each evaluated with the scheme's own native face flux. This module is the
framework side (node fields, node-mean face flux — exactly the conserved
form the integrator's continuity residual integrates);
scripts/simple_solver.py's `mass_res` is the same statistic on Rhie-Chow
fluxes (rho = 1 ⇒ volumetric).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def face_area_vectors(mesh: Dict[str, np.ndarray]) -> np.ndarray:
    """[E, 2] face area vectors oriented OUT of the owner cell (same
    construction as scripts/simple_solver.py::FvMesh)."""
    pos = np.asarray(mesh["node|pos"], np.float64)
    face_node = np.asarray(mesh["face|face_node"], np.int64)
    nc = np.asarray(mesh["face|neighbour_cell"], np.int64)
    own, nb = nc[0], nc[1]
    interior = own != nb
    centroid = np.asarray(mesh["cell|centroid"], np.float64)
    face_center = np.asarray(mesh["face|face_center_pos"], np.float64)

    d = pos[face_node[1]] - pos[face_node[0]]
    n = np.stack([d[:, 1], -d[:, 0]], axis=1)
    to_nb = np.where(interior[:, None],
                     centroid[nb] - centroid[own],
                     face_center - centroid[own])
    flip = np.sum(n * to_nb, axis=1) < 0
    n[flip] = -n[flip]
    return n


def node_mass_imbalance_l1(mesh: Dict[str, np.ndarray],
                           u: np.ndarray, v: np.ndarray
                           ) -> Tuple[float, float]:
    """(Σ_cells |net face flux| / Q_in, Q_in) for a NODE velocity field
    with node-mean face fluxes — the framework's native flux. Q_in is the
    inlet volumetric flow computed from the same fluxes (boundary faces
    with net inflow), so the statistic is dimensionless and matches
    scripts/simple_solver.py's `mass_res` normalization."""
    face_node = np.asarray(mesh["face|face_node"], np.int64)
    nc = np.asarray(mesh["face|neighbour_cell"], np.int64)
    own, nb = nc[0], nc[1]
    interior = own != nb
    sf = face_area_vectors(mesh)

    u = np.asarray(u, np.float64).reshape(-1)
    v = np.asarray(v, np.float64).reshape(-1)
    uf = 0.5 * (u[face_node[0]] + u[face_node[1]])
    vf = 0.5 * (v[face_node[0]] + v[face_node[1]])
    flux = uf * sf[:, 0] + vf * sf[:, 1]

    n_cells = int(np.asarray(mesh["cell|centroid"]).shape[0])
    imb = np.zeros(n_cells)
    np.add.at(imb, own, flux)
    np.add.at(imb, nb[interior], -flux[interior])

    q_in = -np.sum(np.minimum(flux[~interior], 0.0))
    return float(np.abs(imb).sum() / max(q_in, 1e-300)), float(q_in)
