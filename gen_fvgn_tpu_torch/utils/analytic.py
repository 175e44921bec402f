"""Analytic scalar test field with exact derivatives.

Counterpart of `gen_fvgn_tpu/utils/analytic.py`: the accuracy oracle of the
WLSQ and interpolation checks, φ = φ0 + φx sin(αx π x / L) + φy sin(αy π
y / L) + φxy cos(αxy π x y / L²), with its gradient and Hessian from
`torch.func` (the JAX module takes them from jax.grad and jax.hessian).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def scalar_field_fn(phi_0=1.0, phi_x=0.5, phi_y=0.3, phi_xy=0.2,
                    alpha_x=1.5, alpha_y=1.2, alpha_xy=1.0, L=1.0):
    def phi(p):
        x, y = p[0], p[1]
        return (phi_0
                + phi_x * torch.sin(alpha_x * math.pi * x / L)
                + phi_y * torch.sin(alpha_y * math.pi * y / L)
                + phi_xy * torch.cos(alpha_xy * math.pi * x * y / L ** 2))
    return phi


def eval_field(pos: np.ndarray, **kw
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (phi [N,1], grad [N,2], hessian [N,2,2]) exactly, in the
    type of `pos` (float64 or float32)."""
    from torch.func import grad, hessian, vmap
    phi = scalar_field_fn(**kw)
    dtype = torch.float64 if pos.dtype == np.float64 else torch.float32
    p = torch.as_tensor(np.asarray(pos), dtype=dtype)
    vals = vmap(phi)(p)
    grads = vmap(grad(phi))(p)
    hess = vmap(hessian(phi))(p)
    return (vals.numpy()[:, None], grads.numpy(), hess.numpy())
