"""Finite-volume residual: shared result types.

Counterpart of `gen_fvgn_tpu/fv/integrator.py`, cut to `FVLosses`; the
segment-engine assembly of that file belongs to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FVLosses(NamedTuple):
    cont: torch.Tensor     # [B]
    mom_x: torch.Tensor    # [B]
    mom_y: torch.Tensor    # [B]
    press: torch.Tensor    # [B]
