"""One environment's physics from its boundary-condition combination:
the dimensionless coefficient vector theta, the scales, the initial field
and the Dirichlet targets (Gen-FVGN's `set_theta_PDE` / `init_env`).

theta = [unsteady, continuity, convection, grad_p / rho, diffusion,
source / U, U_in_x, U_in_y, Re]; diffusion is mu / (rho U) where the
convection coefficient is non-zero, else mu / U.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from benchmark.reference.mesh import IN_WALL, INFLOW, PRESS_POINT, WALL


def env_physics(coef: Dict, combo: Dict, node_type: np.ndarray) -> Dict:
    """`coef`: the BC file's fixed coefficients (unsteady, continuity,
    convection, grad_p, sigma); `combo`: one combination (u, rho, mu,
    source, aoa, dt, L). Returns float64 arrays theta [9], uvp_dim [3],
    sigma [3], dt (dimensionless, dt * U), uvp0 [N, 3] (dimensional; the
    field at rest, the lid at speed U, lid corners at half) and target_uv
    [N, 2] (dimensionless)."""
    u, rho, mu = combo["u"], combo["rho"], combo["mu"]
    ang = math.radians(combo["aoa"])
    u_in = np.asarray([u * math.cos(ang), u * math.sin(ang)])
    conv = float(coef["convection"])
    diff = mu / u if conv == 0 else mu / (rho * u)
    re = u * (rho if rho != 0 else 1.0) * combo["L"] / mu if mu else 0.0
    theta = np.asarray([coef["unsteady"], coef["continuity"], conv,
                        coef["grad_p"] / rho, diff, combo["source"] / u,
                        u_in[0], u_in[1], re], np.float64)
    n = node_type.shape[0]
    uvp0 = np.zeros((n, 3))
    lid = np.isin(node_type, (INFLOW, IN_WALL, PRESS_POINT))
    uvp0[lid, 0:2] = u_in
    uvp0[node_type == WALL, 0:2] = 0.0
    uvp0[node_type == IN_WALL] /= 2.0
    return {"theta": theta, "uvp_dim": np.asarray([u, u, u * u]),
            "sigma": np.asarray(coef["sigma"], np.float64),
            "dt": combo["dt"] * u, "uvp0": uvp0,
            "target_uv": uvp0[:, 0:2] / u}
