"""Per-environment physics preparation (host-side NumPy).

Builds the dimensionless θ_PDE vector, the initial field, and the Dirichlet
targets for one (mesh × sampled coefficients) environment. Behavior parity
with reference `src/Load_mesh/Load_mesh.py` (`set_theta_PDE` :134-211,
`init_env` :79-131, `makedimless` :213-244) and `src/Load_mesh/Set_BC.py`
(`velocity_profile` :6-66).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from gen_fvgn_tpu_torch.meshes.bc import ThetaSample
from gen_fvgn_tpu_torch.utils.types import NodeType


def velocity_profile(pos: np.ndarray, mean_u: float, aoa: float,
                     profile: Optional[object]) -> Tuple[np.ndarray, np.ndarray]:
    """Inlet / initial velocity profiles. Returns (uv [N,2], p [N,1])."""
    n = pos.shape[0]
    uv = np.zeros((n, 2), dtype=np.float32)
    p = np.zeros((n, 1), dtype=np.float32)
    if n == 0:
        return uv, p

    if isinstance(profile, (list, tuple)) and len(profile) == 3:
        # explicit uniform [u, v, p] initial values
        uv[:, 0] = float(profile[0])
        uv[:, 1] = float(profile[1])
        p[:, 0] = float(profile[2])
    elif profile == "parabolic":
        y = pos[:, 1] - pos[:, 1].min()
        h = y.max() - y.min()
        uv[:, 0] = 6.0 * mean_u * y * (h - y) / (h ** 2)
    elif profile == "uniform":
        uv[:, 0] = mean_u
    elif profile == "uniform_aoa":
        uv[:, 0] = mean_u * math.cos(math.radians(aoa))
        uv[:, 1] = mean_u * math.sin(math.radians(aoa))
    elif profile == "Taylor_Green":
        x, y = pos[:, 0], pos[:, 1]
        uv[:, 0] = mean_u * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
        uv[:, 1] = -mean_u * np.cos(2 * np.pi * x) * np.sin(2 * np.pi * y)
        p[:, 0] = -0.25 * mean_u * (np.cos(4 * np.pi * x) + np.cos(4 * np.pi * y))
    elif profile is None:
        pass  # wave equation: zero inlet
    else:
        raise ValueError(f"unknown velocity profile {profile!r}")
    return uv, p


def pressure_point_source(pos, center, source_frequency, source_strength,
                          dt, time_index):
    """Gaussian point pressure source at the domain center for the wave
    equation (parity: Set_BC.py `generate_pressure_source` :68-113).

    pos [N,2], center [2] NumPy arrays; returns [N,1]. time_index must be
    >= 1.
    """
    xp = np
    rel = pos - center[None, :]
    magnitude = xp.exp(-(rel[:, 0:1] ** 2 + rel[:, 1:2] ** 2)
                       * source_strength * 1000.0)
    current_time = dt * time_index
    return xp.sin(source_frequency * np.pi * current_time) * magnitude


def make_wave_source_fn(pos: np.ndarray, ts: ThetaSample, n_pad: int,
                        batch_size: int):
    """Build the rollout-time wave source callback: time_index -> [B, n_pad]
    pressure signal (zero-padded), for solve.rollout(wave_source_fn=...)."""
    pos = np.asarray(pos, np.float32)
    center = pos.mean(axis=0)

    def fn(time_index: int) -> np.ndarray:
        sig = pressure_point_source(
            pos, center, ts.source_frequency, ts.source_strength, ts.dt,
            time_index).reshape(-1).astype(np.float32)
        out = np.zeros((batch_size, n_pad), np.float32)
        out[:, : sig.shape[0]] = sig
        return out

    return fn


def theta_vector(theta_bak: dict, ts: ThetaSample) -> Dict[str, np.ndarray]:
    """Assemble the 9-dim θ_PDE = [unsteady, continuity, convection, grad_p/ρ,
    diffusion, source/U, U_in_x, U_in_y, Re], plus dt_graph and uvp_dim.

    diffusion = μ/U for Poisson (convection coefficient 0), μ/(ρU) for NS.
    """
    u = ts.mean_u
    u_in = np.asarray([u * math.cos(math.radians(ts.aoa)),
                       u * math.sin(math.radians(ts.aoa))], dtype=np.float32)
    convection = float(theta_bak["convection"])
    diffusion = (ts.mu / u) if convection == 0 else (ts.mu / (ts.rho * u))
    theta = np.asarray([
        float(theta_bak["unsteady"]),
        float(theta_bak["continuity"]),
        convection,
        float(theta_bak["grad_p"]) / ts.rho,
        diffusion,
        ts.source / u,
        u_in[0],
        u_in[1],
        ts.Re,
    ], dtype=np.float32)
    return {
        "theta_PDE": theta,
        "dt_graph": np.asarray(ts.dt * u, dtype=np.float32),
        "uvp_dim": np.asarray([u, u, u * u], dtype=np.float32),
    }


def init_environment(pos: np.ndarray, node_type: np.ndarray, ts: ThetaSample,
                     inlet_type, init_field_type
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Initial field + dimensionless Dirichlet targets.

    Returns (uvp [N,3] dimensional initial state, target_uv [N,2] = uv/U).
    """
    uv, p = velocity_profile(pos, ts.mean_u, ts.aoa, init_field_type)
    uvp = np.concatenate([uv, p], axis=1).astype(np.float32)

    wall = node_type == NodeType.WALL_BOUNDARY
    inlet = ((node_type == NodeType.INFLOW) |
             (node_type == NodeType.IN_WALL) |
             (node_type == NodeType.PRESS_POINT))
    in_wall = node_type == NodeType.IN_WALL

    inlet_uv, _ = velocity_profile(pos[inlet], ts.mean_u, ts.aoa, inlet_type)
    uvp[inlet, 0:2] = inlet_uv
    uvp[wall, 0:2] = 0.0
    uvp[in_wall] = uvp[in_wall] / 2.0   # inflow∩wall corners carry half inflow

    target_uv = (uvp[:, 0:2] / ts.mean_u).astype(np.float32)
    return uvp, target_uv
