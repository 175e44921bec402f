"""Weighted-least-squares (WLSQ) gradient reconstruction.

Counterpart of `gen_fvgn_tpu/ops/wlsq.py`. The per-mesh statics run on the
host in NumPy: the moments (normal matrix, one-way B rows, column scaling)
and the float64 fold of the per-node solve into one static matrix. The
block engine's runtime gradient is one sparse apply of the folded operator
(graph/operators.py); the segment engine's is `node_based_wlsq_precomputed`
below (batch-major torch tensors): the weighted differences accumulated
per node by segment sums, then the folded solve as a batched product.
`node_based_wlsq` is the LU form: the per-node system row-normalized,
with the order-dependent ridge, solved at run time by a batched LU in the
operands' type (and the condition numbers with `rt_cond`).

The moments are evaluated in float32, operation by operation as the JAX
function evaluates them, so the two packages fold the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gen_fvgn_tpu_torch.ops.segment import gather_rows, segment_sum

# derivative-vector length per order
WLSQ_DIM = {"1st": 2, "2nd": 5, "3rd": 9, "4th": 14}

# Sign of each basis column under d -> -d (monomial parity): odd-degree
# columns flip. Layout matches taylor_basis below.
_COLUMN_PARITY = np.asarray(
    [-1.0, -1.0,                      # dx, dy                (degree 1)
     1.0, 1.0, 1.0,                   # dx²/2, dy²/2, dxdy    (degree 2)
     -1.0, -1.0, -1.0, -1.0,          # cubic terms           (degree 3)
     1.0, 1.0, 1.0, 1.0, 1.0],        # quartic terms         (degree 4)
    np.float32)

# Monomial total degree of each basis column (for local length scaling).
_COLUMN_DEGREE = np.asarray(
    [1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 3.0, 4.0, 4.0, 4.0, 4.0, 4.0],
    np.float32)

# Per-axis monomial degrees (ax, ay) of each column — anisotropic scaling:
# each column is scaled by Lx^-ax · Ly^-ay.
_COLUMN_DEGREE_X = np.asarray(
    [1.0, 0.0, 2.0, 0.0, 1.0, 3.0, 0.0, 2.0, 1.0, 4.0, 3.0, 2.0, 1.0, 0.0],
    np.float32)
_COLUMN_DEGREE_Y = np.asarray(
    [0.0, 1.0, 0.0, 2.0, 1.0, 0.0, 3.0, 1.0, 2.0, 0.0, 1.0, 2.0, 3.0, 4.0],
    np.float32)


def odd_sign_vector(order: str) -> np.ndarray:
    return _COLUMN_PARITY[: WLSQ_DIM[order]]


def column_degrees(order: str) -> np.ndarray:
    return _COLUMN_DEGREE[: WLSQ_DIM[order]]


def column_degrees_xy(order: str):
    k = WLSQ_DIM[order]
    return _COLUMN_DEGREE_X[:k], _COLUMN_DEGREE_Y[:k]


def taylor_basis(d: np.ndarray, order: str) -> np.ndarray:
    """Taylor displacement basis for edge displacement d = pos_out - pos_in.

    d: [M, 2] -> [M, k] with k = WLSQ_DIM[order]. Column layout:
      1st: [dx, dy]
      2nd: + [dx²/2, dy²/2, dx·dy]
      3rd: + [dx³/6, dy³/6, dx²dy/2, dy²dx/2]
      4th: + [dx⁴/24, dx³dy/6, dx²dy²/4, dxdy³/6, dy⁴/24]
    """
    if order not in WLSQ_DIM:
        raise ValueError(f"order must be one of {list(WLSQ_DIM)}, got {order!r}")
    f = d.dtype.type
    dx, dy = d[:, 0:1], d[:, 1:2]
    cols = [dx, dy]
    if order in ("2nd", "3rd", "4th"):
        cols += [f(0.5) * dx * dx, f(0.5) * dy * dy, dx * dy]
    if order in ("3rd", "4th"):
        cols += [dx ** 3 / f(6.0), dy ** 3 / f(6.0),
                 f(0.5) * dx * dx * dy, f(0.5) * dy * dy * dx]
    if order == "4th":
        cols += [dx ** 4 / f(24.0), dx ** 3 * dy / f(6.0),
                 f(0.25) * dx * dx * dy * dy, dx * dy ** 3 / f(6.0),
                 dy ** 4 / f(24.0)]
    return np.concatenate(cols, axis=-1)


def _segment_sum(data: np.ndarray, ids: np.ndarray, num: int,
                 mask: Optional[np.ndarray]) -> np.ndarray:
    if mask is not None:
        m = mask.astype(data.dtype)
        data = data * m.reshape(m.shape + (1,) * (data.ndim - m.ndim))
    out = np.zeros((num,) + data.shape[1:], data.dtype)
    np.add.at(out, ids, data)
    return out


def wlsq_moments(
    pos: np.ndarray,             # [N, 2]
    stencil: np.ndarray,         # [2, Es] one-way node pairs (s, r)
    order: str,
    stencil_mask: Optional[np.ndarray] = None,  # [Es] bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-node normal matrix A, the one-way B rows, and the local column
    scaling, in float32.

    Each stored edge (s, r) contributes twice (both directions):
      direction (s→r): d = pos[s]-pos[r], accumulates at r;
      direction (r→s): d flips sign,     accumulates at s.
    Under d → -d the basis columns pick up their parity sign, so the reverse
    outer product is (signs·signsᵀ) ⊙ (d dᵀ).

    Local coordinate scaling: each column c is divided by Lx^ax · Ly^ay,
    with (Lx, Ly) the per-axis rms stencil displacement at the node; without
    it the higher-order normal matrices are numerically singular in f32.

    Returns:
      A        [N, k, k] — scaled normal matrix per node (both directions);
      single_B [Es, k]   — unscaled w·d rows for the stored (s→r) direction;
      colscale [N, k]    — the column scaling; the solve's solution times
                            colscale gives physical derivatives.
    """
    pos = np.asarray(pos, np.float32)
    s, r = stencil[0], stencil[1]
    n_nodes = pos.shape[0]
    f = np.float32
    d = pos[s] - pos[r]                                  # [Es, 2]
    norm = np.sqrt(np.sum(d * d, axis=1, keepdims=True))
    w = f(1.0) / np.where(norm > 0, norm, f(1.0))        # guard padded slots
    disp = taylor_basis(d, order)                        # [Es, k]
    wB = w * disp                                        # [Es, k]

    d2 = d ** 2                                          # [Es, 2]
    l2 = _segment_sum(d2, r, n_nodes, stencil_mask) + \
        _segment_sum(d2, s, n_nodes, stencil_mask)       # [N, 2]
    ones = np.ones_like(norm)
    cnt = _segment_sum(ones, r, n_nodes, stencil_mask) + \
        _segment_sum(ones, s, n_nodes, stencil_mask)     # [N, 1]
    L = np.sqrt(l2 / np.maximum(cnt, f(1.0)))            # [N, 2] (Lx, Ly)
    L = np.where(L > 0, L, f(1.0)).astype(f)
    deg_x, deg_y = column_degrees_xy(order)
    colscale = (L[:, 0:1] ** (-deg_x[None, :])) * \
        (L[:, 1:2] ** (-deg_y[None, :]))                 # [N, k]
    colscale = colscale.astype(f)

    signs = odd_sign_vector(order)
    cs_r = colscale[r]                                   # [Es, k]
    cs_s = colscale[s]
    row_fwd = wB * cs_r
    disp_fwd = disp * cs_r
    outer_fwd = row_fwd[:, :, None] * disp_fwd[:, None, :]
    row_rev = wB * cs_s
    disp_rev = disp * cs_s
    parity = signs[:, None] * signs[None, :]
    outer_rev = (row_rev[:, :, None] * disp_rev[:, None, :]) * parity
    A = _segment_sum(outer_fwd, r, n_nodes, stencil_mask) + \
        _segment_sum(outer_rev, s, n_nodes, stencil_mask)
    return A.astype(f), wB.astype(f), colscale


# Ridge added to the row-normalized A: zero for orders 1-2 (full-rank on any
# valid stencil); orders 3-4 need it to keep rank-deficient corner stencils
# finite.
_RIDGE = {"1st": 0.0, "2nd": 0.0, "3rd": 1e-6, "4th": 1e-6}


def wlsq_solve_matrix(A: np.ndarray, colscale: np.ndarray,
                      node_mask: Optional[np.ndarray] = None,
                      order: str = "2nd") -> np.ndarray:
    """Fold the per-node WLSQ solve into one static matrix (host, float64).

    The normal matrix A is geometry-only, so row normalization, ridge and
    inversion are precomputed per mesh:

        S = diag(colscale) · (A/rownorm + λI)⁻¹ · diag(1/rownorm)

    and the runtime solve becomes `nabla = S @ B_raw`.
    """
    A = np.asarray(A, dtype=np.float64)
    colscale = np.asarray(colscale, dtype=np.float64)
    k = A.shape[-1]
    rn = np.linalg.norm(A, axis=2, keepdims=True)
    A_n = A / (rn + 1e-8) + _RIDGE[order] * np.eye(k)[None]
    if node_mask is not None:
        m = np.asarray(node_mask, bool)
        A_n = np.where(m[:, None, None], A_n, np.eye(k)[None])
    S = np.linalg.inv(A_n) / (rn.transpose(0, 2, 1) + 1e-8)
    S = colscale[:, :, None] * S
    if node_mask is not None:
        S = S * np.asarray(node_mask, np.float64)[:, None, None]
    return S.astype(np.float32)


def accumulate_B(phi: torch.Tensor, stencil: torch.Tensor,
                 single_B: torch.Tensor, order: str,
                 colscale: Optional[torch.Tensor],
                 stencil_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Two-direction weighted Δφ accumulation: phi [B, N, C], stencil
    [B, 2, Es], single_B [B, Es, k], colscale [B, N, k] -> [B, N, k, C]."""
    s, r = stencil[:, 0], stencil[:, 1]
    n_nodes = phi.shape[1]
    k = single_B.shape[-1]
    if colscale is None:
        colscale = torch.ones(phi.shape[:2] + (k,), dtype=phi.dtype,
                              device=phi.device)
    dphi = gather_rows(phi, s) - gather_rows(phi, r)             # [B,Es,C]
    signs = torch.from_numpy(odd_sign_vector(order)).to(single_B.device)
    row_fwd = single_B * gather_rows(colscale, r)
    row_rev = (single_B * signs) * gather_rows(colscale, s)
    contrib_fwd = row_fwd[..., :, None] * dphi[..., None, :]      # [B,Es,k,C]
    contrib_rev = row_rev[..., :, None] * (-dphi)[..., None, :]
    return segment_sum(contrib_fwd, r, n_nodes, stencil_mask) + \
        segment_sum(contrib_rev, s, n_nodes, stencil_mask)       # [B,N,k,C]


def node_based_wlsq_precomputed(
    phi: torch.Tensor,            # [B, N, C]
    stencil: torch.Tensor,        # [B, 2, Es]
    solve_matrix: torch.Tensor,   # [B, N, k, k] from wlsq_solve_matrix
    single_B: torch.Tensor,       # [B, Es, k]
    order: str,
    colscale: torch.Tensor,       # [B, N, k]
    stencil_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Runtime WLSQ with the static solve folded into a batched product:
    [B, N, C, k] derivatives per node and channel (float32)."""
    acc = accumulate_B(phi, stencil, single_B, order, colscale,
                       stencil_mask)
    nabla = torch.matmul(solve_matrix.to(torch.float32),
                         acc.to(torch.float32))                   # [B,N,k,C]
    return nabla.transpose(-1, -2)


def node_based_wlsq(
    phi: torch.Tensor,            # [B, N, C] (or [N, C])
    stencil: torch.Tensor,        # [B, 2, Es] (or [2, Es])
    A: torch.Tensor,              # [B, N, k, k] from wlsq_moments
    single_B: torch.Tensor,       # [B, Es, k] from wlsq_moments (unscaled)
    order: str,
    colscale: Optional[torch.Tensor] = None,      # [B, N, k]
    stencil_mask: Optional[torch.Tensor] = None,  # [B, Es]
    node_mask: Optional[torch.Tensor] = None,     # [B, N]
    rt_cond: bool = False,
):
    """Solve the WLSQ normal equations of every node (JAX
    `ops/wlsq.py::node_based_wlsq`). Returns the derivatives [B, N, C, k]
    ([..., 0:2] the gradient; 2:5 uxx, uyy, uxy at 2nd order, and so on);
    with rt_cond also the condition number of each node's row-normalized
    A [B, N] (largest over smallest singular value). Without a batch axis
    ([N, C], [2, Es], [N, k, k], ...) the results have none either.

    The rows of A and B are divided by the row norms of A (plus 1e-8) for
    conditioning, orders 3 and 4 add a 1e-6 ridge, padded nodes
    (node_mask False) solve an identity system with a zero right-hand
    side, and the solution is multiplied by colscale."""
    if phi.ndim == 2:
        add = lambda t: None if t is None else t[None]
        out = node_based_wlsq(phi[None], stencil[None], A[None],
                              single_B[None], order, add(colscale),
                              add(stencil_mask), add(node_mask), rt_cond)
        return tuple(o[0] for o in out) if rt_cond else out[0]
    k = single_B.shape[-1]
    if colscale is None:
        colscale = torch.ones(phi.shape[:2] + (k,), dtype=phi.dtype,
                              device=phi.device)
    B = accumulate_B(phi, stencil, single_B, order, colscale, stencil_mask)

    row_norms = torch.linalg.vector_norm(A, dim=-1, keepdim=True)  # [B,N,k,1]
    A_n = A / (row_norms + 1e-8)
    B_n = B / (row_norms + 1e-8)
    if _RIDGE[order]:
        A_n = A_n + _RIDGE[order] * torch.eye(k, dtype=A_n.dtype,
                                              device=A_n.device)
    if node_mask is not None:
        eye = torch.eye(k, dtype=A_n.dtype, device=A_n.device)
        m = node_mask.to(A_n.dtype)[..., None, None]
        A_n = A_n * m + eye * (1.0 - m)
        B_n = B_n * m

    nabla = torch.linalg.solve(A_n, B_n)                      # [B,N,k,C]
    nabla = (nabla * colscale[..., None]).transpose(-1, -2)   # [B,N,C,k]
    if rt_cond:
        sv = torch.linalg.svdvals(A_n)
        return nabla, sv[..., 0] / torch.clamp(sv[..., -1], min=1e-30)
    return nabla
