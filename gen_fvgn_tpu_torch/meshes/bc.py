"""BC.json loading and θ_PDE combination generation.

BC.json is the per-mesh physics config (the dataset's API — README.md:157-183):
geo-id → boundary mapping, PDE-coefficient ranges [start, step, end], dt
("1/Re" supported), characteristic length L, Reynolds bounds, output-channel
mask sigma, inlet / init-field profile types, and stencil k-hops.

Parity: get_param.py `generate_list` :87-94, `generate_combinations` :96-137.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass
from typing import List

import numpy as np


def load_bc(path: str) -> dict:
    with open(path, "rt") as f:
        return json.load(f)


def _range_list(spec) -> List[float]:
    """Expand [min, step, max] to the inclusive value list."""
    lo, step, hi = spec
    if lo == step == hi:
        return [float(hi)]
    num = int(round((hi - lo) / step)) + 1
    return list(np.linspace(lo, hi, num))


@dataclass(frozen=True)
class ThetaSample:
    """One sampled PDE instance: the physical coefficients of a combination.

    source_frequency / source_strength parameterize the wave family's
    Gaussian point pressure source (reference Set_BC.py:68-113; validity
    rules README.md:188-206 — they must be 0 for NS/Poisson)."""
    mean_u: float
    rho: float
    mu: float
    source: float
    aoa: float
    dt: float
    L: float
    source_frequency: float = 0.0
    source_strength: float = 0.0

    @property
    def Re(self) -> float:
        if self.mu == 0:
            return 0.0
        rho = self.rho if self.rho != 0.0 else 1.0
        return self.mean_u * rho * self.L / self.mu


def generate_theta_combinations(theta_pde: dict) -> List[ThetaSample]:
    """All (U, rho, mu, source, aoa) grid combinations whose Reynolds number
    lies within [Re_min, Re_max]. dt may be the string "1/Re".
    """
    u_list = _range_list(theta_pde["inlet"])
    rho_list = _range_list(theta_pde["rho"])
    mu_list = _range_list(theta_pde["mu"])
    source_list = _range_list(theta_pde["source"])
    aoa_list = _range_list(theta_pde["aoa"])
    freq_list = _range_list(theta_pde.get("source_frequency", [0, 0, 0]))
    strength_list = _range_list(theta_pde.get("source_strength", [0, 0, 0]))
    dt_spec = theta_pde["dt"]
    L = float(theta_pde["L"])
    re_max = float(theta_pde["Re_max"])
    re_min = float(theta_pde["Re_min"])
    is_wave = any(f != 0 for f in freq_list)

    out: List[ThetaSample] = []
    for u, rho, mu, src, aoa, freq, strength in itertools.product(
            u_list, rho_list, mu_list, source_list, aoa_list,
            freq_list, strength_list):
        rho_eff = rho if rho != 0.0 else 1.0
        re = (u * rho_eff * L) / mu if mu != 0 else 0.0
        # the wave family has mu = 0 (README.md:188-206), so the Re window
        # cannot apply; every sampled (frequency, strength) pair is valid
        if not is_wave and not (re_min <= re <= re_max):
            continue
        if dt_spec == "1/Re":
            dt = 1.0 / re
        elif isinstance(dt_spec, (int, float)):
            dt = float(dt_spec)
        else:
            raise ValueError(f"BC.json dt must be a number or '1/Re', got {dt_spec!r}")
        out.append(ThetaSample(u, rho, mu, src, aoa, dt, L, freq, strength))

    if not out:
        raise ValueError("no valid θ_PDE combination satisfies the Re bounds; "
                         "check BC.json ranges")
    return out
