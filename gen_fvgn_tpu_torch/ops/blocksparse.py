"""Static sparse operators fixed by the mesh, and their application.

Counterpart of `gen_fvgn_tpu/ops/blocksparse.py`. Every graph operation
(neighbour aggregation, edge↔node transfers, WLSQ gradients, FV
interpolation and flux accumulation) is a static sparse linear operator.
The JAX package stores each as 256×256 dense tiles along its band, which is
what a matrix unit wants; on a GPU the operators have a few to a few tens
of non-zeros a row and the apply is a gather-accumulate bounded by bytes, so
the port stores each direction as CSR (row pointers, column indices,
values), with the transpose built explicitly from the same COO triplets.

`apply_linop(op, x)` keeps three behaviours of the JAX `_apply_block_op`:

* a pure row-gather operator (`take_idx`) applied to rows of at least 256
  bytes is a row gather in the operand's own type; its padded output rows
  read row 0 and are NOT zero;
* an operator stored in bfloat16 casts its operand to bfloat16 first;
* the output is bfloat16 only for a bfloat16 operand and a bfloat16
  operator, float32 otherwise.

Applies whose feature width is a multiple of 128 (and that do not take the
row-gather route) go to the `spmm` CUDA kernel (ops/spmm.py) — the JAX
dispatch rule for its Pallas kernels. Narrower applies (edge_diff at 12
channels, the float32 FV/WLSQ streams) are outside any kernel in the JAX
package as well; here they are one `torch.sparse` CSR product.

`apply_gather_pair` and `apply_node_pair` are the paired applies of the
JAX package's `use_gather_pair()` / `use_node_pair()` forms: two operators
with the same rows applied to the two halves of one operand and summed
through one float32 accumulator (kernel K8, ops/pair_spmm.py); the node
pair's backward applies both stored transposes in one pass (K9).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class CsrOp:
    """One direction of a static sparse operator [n_out, n_in] in CSR.

    dtype is the operator's storage type in the sense of the JAX package:
    torch.bfloat16 for the structural message-passing operators (entries are
    small integers, exact in bf16), torch.float32 for the FV/WLSQ operators.
    The values themselves are kept in float32 (for a bf16 operator they are
    rounded through bf16 first): the kernel and the plain version both
    accumulate in float32.

    take_idx: for pure row-gather operators the row indices [n_out] (padded
    rows index 0).
    """
    crow: torch.Tensor            # [n_out + 1] int32
    col: torch.Tensor             # [nnz] int32
    val: torch.Tensor             # [nnz] float32
    n_out: int
    n_in: int
    dtype: torch.dtype
    take_idx: Optional[torch.Tensor] = None   # [n_out] int64
    _csr: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "CsrOp":
        return CsrOp(
            crow=self.crow.to(device), col=self.col.to(device),
            val=self.val.to(device), n_out=self.n_out, n_in=self.n_in,
            dtype=self.dtype,
            take_idx=None if self.take_idx is None
            else self.take_idx.to(device))

    def csr(self) -> torch.Tensor:
        """The operator as a float32 torch sparse CSR tensor (cached)."""
        if self._csr is None:
            with warnings.catch_warnings():
                # torch announces once that sparse CSR support is in beta
                warnings.filterwarnings("ignore", message="Sparse CSR")
                self._csr = torch.sparse_csr_tensor(
                    self.crow, self.col, self.val,
                    size=(self.n_out, self.n_in), check_invariants=False)
        return self._csr

    def to_dense(self) -> torch.Tensor:
        return self.csr().to_dense()


@dataclass
class LinOp:
    """A sparse operator with its explicit transpose (the backward of a
    later training slice applies `bwd`, never a scatter)."""
    fwd: CsrOp
    bwd: CsrOp

    def to(self, device) -> "LinOp":
        return LinOp(fwd=self.fwd.to(device), bwd=self.bwd.to(device))


def _resolve_dtype(dtype) -> torch.dtype:
    if dtype in (torch.bfloat16, "bfloat16"):
        return torch.bfloat16
    if dtype in (torch.float32, np.float32, "float32"):
        return torch.float32
    raise ValueError(f"operator dtype must be float32 or bfloat16, got {dtype!r}")


def build_csr_op(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_out: int, n_in: int, dtype=np.float32,
                 take_idx: Optional[np.ndarray] = None) -> CsrOp:
    """Assemble CSR from COO triplets (duplicates accumulate, in float64).

    n_out / n_in are the PADDED sizes; rows without entries (the padding)
    stay empty, so they come out exactly zero."""
    tdtype = _resolve_dtype(dtype)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    key = rows * n_in + cols
    uniq, inverse = np.unique(key, return_inverse=True)
    acc = np.zeros(uniq.shape[0], np.float64)
    np.add.at(acc, inverse.reshape(-1), vals)
    r = uniq // n_in                                  # ascending (row-major)
    c = uniq % n_in
    counts = np.bincount(r, minlength=n_out)
    crow = np.zeros(n_out + 1, np.int64)
    np.cumsum(counts, out=crow[1:])
    val = torch.from_numpy(acc.astype(np.float32))
    if tdtype == torch.bfloat16:
        val = val.to(torch.bfloat16).to(torch.float32)
    return CsrOp(
        crow=torch.from_numpy(crow.astype(np.int32)),
        col=torch.from_numpy(c.astype(np.int32)),
        val=val, n_out=int(n_out), n_in=int(n_in), dtype=tdtype,
        take_idx=None if take_idx is None
        else torch.from_numpy(np.asarray(take_idx, np.int64)))


def build_linop(rows, cols, vals, n_out: int, n_in: int,
                dtype=np.float32,
                fwd_take: Optional[np.ndarray] = None) -> LinOp:
    """fwd_take: explicit row-gather indices [n_out] (pad rows 0) enabling
    the row-gather route on the forward direction; the transpose stays a
    sparse product."""
    return LinOp(
        fwd=build_csr_op(rows, cols, vals, n_out, n_in, dtype,
                         take_idx=fwd_take),
        bwd=build_csr_op(cols, rows, vals, n_in, n_out, dtype))


def _out_dtype(op: CsrOp, x: torch.Tensor) -> torch.dtype:
    """bf16 operand AND bf16 operator (the model message-passing path):
    emit bf16. FV/WLSQ operators are float32, so numerical paths still
    accumulate and emit float32."""
    return (torch.bfloat16
            if (x.dtype == torch.bfloat16 and op.dtype == torch.bfloat16)
            else torch.float32)


def csr_matmul(op: CsrOp, x: torch.Tensor) -> torch.Tensor:
    """The apply as one `torch.sparse` CSR product, on any device: the
    operand is cast to bfloat16 when the operator is stored bfloat16, the
    product accumulates in float32, and the output type follows
    `_out_dtype`. x: [n_in, F] or [B, n_in, F] (the batch is folded into the
    columns, so the operator is read once).

    This is the route of the narrow and float32 applies (edge_diff at 12
    channels, the FV/WLSQ streams), which are outside any kernel in the JAX
    package too; it is also the arithmetic the spmm kernel's plain version
    states (ops/spmm.py::spmm_reference)."""
    out_dtype = _out_dtype(op, x)
    xin = x.to(torch.bfloat16) if op.dtype == torch.bfloat16 else x
    return csr_matmul_f32(op, xin).to(out_dtype).contiguous()


def csr_matmul_f32(op: CsrOp, x: torch.Tensor) -> torch.Tensor:
    """A @ x as one `torch.sparse` CSR product in float32, unrounded: x is
    taken as it is (no cast for a bf16-stored operator), the batch of
    [B, n_in, F] folded into the columns."""
    xf = x.to(torch.float32).contiguous()
    a = op.csr()
    if x.ndim == 2:
        return torch.sparse.mm(a, xf)
    b, n_in, f = xf.shape
    flat = xf.permute(1, 0, 2).reshape(n_in, b * f)
    return torch.sparse.mm(a, flat).reshape(op.n_out, b, f).permute(1, 0, 2)


def _apply_csr_op(op: CsrOp, x: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
    """x [n_in, F] or batch-major [B, n_in, F] -> [(B,) n_out, F]; `plain`
    takes the spmm kernel's plain version on any device."""
    from gen_fvgn_tpu_torch.ops.spmm import spmm, spmm_reference
    if x.ndim not in (2, 3):
        raise ValueError(f"apply expects [n_in, F] or [B, n_in, F], got "
                         f"{tuple(x.shape)}")
    if x.shape[-2] != op.n_in:
        raise ValueError(f"operand has {x.shape[-2]} rows, operator takes "
                         f"{op.n_in}")
    f = x.shape[-1]
    if op.take_idx is not None and f * x.element_size() >= 256:
        # a row gather is exact in the operand type — no bf16 round trip
        # even when the (structural) operator is stored bf16
        return torch.index_select(x, x.ndim - 2, op.take_idx)
    if f % 128 == 0:
        # the JAX dispatch rule of the Pallas spmm kernels
        return (spmm_reference if plain else spmm)(op, x)
    return csr_matmul(op, x)


class _ApplyLinop(torch.autograd.Function):
    """out = A·x, with the backward dx = Aᵀ·g applied through the stored
    transpose `op.bwd` under the forward's dispatch rule (the spmm kernel
    K1 at widths that are multiples of 128, `csr_matmul` otherwise; `bwd`
    has no row-gather indices, so the take route's backward is the
    transpose product too). It never scatters. As in JAX, the cotangent
    takes the operand cast of a bf16-stored operator: a float32 cotangent
    is rounded to bf16 before the product."""

    @staticmethod
    def forward(ctx, x, op, plain):
        ctx.op, ctx.plain, ctx.x_dtype = op, plain, x.dtype
        return _apply_csr_op(op.fwd, x, plain)

    @staticmethod
    def backward(ctx, g):
        dx = _apply_csr_op(ctx.op.bwd, g.contiguous(), ctx.plain)
        return dx.to(ctx.x_dtype), None, None


def apply_linop(op: LinOp, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x. x is [n_in, F] or batch-major [B, n_in, F]; under
    autograd the backward applies `op.bwd` (see `_ApplyLinop`)."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    return _ApplyLinop.apply(x, op, plain_versions_active())


class _GatherPair(torch.autograd.Function):
    """pres = Gs·y[..., :H] + Gr·y[..., H:] through K8, and the JAX rule's
    backward dy = [Gsᵀ·g | Grᵀ·g]: two applies on the stored transposes
    (K1 at widths that are multiples of 128), not K9, as in JAX."""

    @staticmethod
    def forward(ctx, y, ops, plain):
        from gen_fvgn_tpu_torch.ops.pair_spmm import (pair_sum,
                                                      pair_sum_reference)
        ctx.ops, ctx.plain, ctx.y_dtype = ops, plain, y.dtype
        return (pair_sum_reference if plain else pair_sum)(
            ops.gather_s.fwd, ops.gather_r.fwd, y, out_dtype=y.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dy = torch.cat([_apply_csr_op(ctx.ops.gather_s.bwd, g, ctx.plain),
                        _apply_csr_op(ctx.ops.gather_r.bwd, g, ctx.plain)],
                       dim=-1)
        return dy.to(ctx.y_dtype), None, None


def apply_gather_pair(ops, y: torch.Tensor) -> torch.Tensor:
    """pres = y[s_e, :H] + y[r_e, H:] for a MeshOperators bundle (JAX
    `ops/blocksparse.py::apply_gather_pair`): y [(B,) n_nodes, 2H] ->
    [(B,) n_edges, H] in y's type. Unlike the take route, padded edge rows
    come out zero (the gather operators have no entries there)."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    return _GatherPair.apply(y, ops, plain_versions_active())


class _NodePair(torch.autograd.Function):
    """nbr_sum = nbr_r·y[..., :h] + nbr_s·y[..., h:] through K8, backward
    dy = [nbr_rᵀ·g | nbr_sᵀ·g] through K9 on the stored transposes. Both
    wrappers round their operand (y, or a float32 cotangent) to bf16 for
    bf16-stored operators, and both outputs take the type of y so cast."""

    @staticmethod
    def forward(ctx, y, ops, plain):
        from gen_fvgn_tpu_torch.ops.pair_spmm import (pair_sum,
                                                      pair_sum_reference)
        ctx.ops, ctx.plain, ctx.y_dtype = ops, plain, y.dtype
        ctx.x_dtype = torch.bfloat16 \
            if ops.nbr_r.fwd.dtype == torch.bfloat16 else y.dtype
        return (pair_sum_reference if plain else pair_sum)(
            ops.nbr_r.fwd, ops.nbr_s.fwd, y, out_dtype=ctx.x_dtype)

    @staticmethod
    def backward(ctx, g):
        from gen_fvgn_tpu_torch.ops.pair_spmm import (
            pair_transpose, pair_transpose_reference)
        dy = (pair_transpose_reference if ctx.plain else pair_transpose)(
            ctx.ops.nbr_r.bwd, ctx.ops.nbr_s.bwd, g.contiguous(),
            out_dtype=ctx.x_dtype)
        return dy.to(ctx.y_dtype), None, None


class _NodeAgg(torch.autograd.Function):
    """The composed NodeBlock aggregation nbr_sum = nbr_r·e[..., :h2] +
    nbr_s·e[..., h2:] as two applies on column windows of the edge stream
    e [(B,) E, h] (h2 = h / 2): each product at width h2, rounded to its
    output type as the full-width applies round (`_out_dtype`), the two
    added in that type. The backward writes nbr_rᵀ·g and nbr_sᵀ·g straight
    into the two halves of one [(B,) E, h] gradient. It gives the bits of
    `(nbr_r·e)[..., :h2] + (nbr_s·e)[..., h2:]` and of that expression's
    autograd backward (whose other halves are exact zeros), with half the
    operand bytes, no zero-filled cotangent and no add of two half-zero
    edge gradients. Windows of a multiple of 64 columns go to K1 (spmm)
    on the card; the plain version (`plain`, or CPU tensors) computes the
    same windows through `spmm_reference`, and narrower ones take
    `csr_matmul`, as the full-width applies do below 128."""

    @staticmethod
    def forward(ctx, e, ops, plain):
        ctx.ops, ctx.plain, ctx.e_dtype = ops, plain, e.dtype
        h2 = e.shape[-1] // 2
        t = _apply_window(ops.nbr_r.fwd, e[..., :h2], plain)
        u = _apply_window(ops.nbr_s.fwd, e[..., h2:], plain)
        return t + u

    @staticmethod
    def backward(ctx, g):
        ops, plain = ctx.ops, ctx.plain
        g = g.contiguous()
        h2 = g.shape[-1]
        out_dtype = _out_dtype(ops.nbr_r.bwd, g)
        de = torch.empty(g.shape[:-2] + (ops.nbr_r.bwd.n_out, 2 * h2),
                         dtype=out_dtype, device=g.device)
        _apply_window(ops.nbr_r.bwd, g, plain, de[..., :h2])
        _apply_window(ops.nbr_s.bwd, g, plain, de[..., h2:])
        return de.to(ctx.e_dtype), None, None


def _apply_window(op: CsrOp, x: torch.Tensor, plain: bool,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A·x for a column window x (and optionally into a window `out`):
    K1 at widths that are multiples of 64, `csr_matmul` below."""
    from gen_fvgn_tpu_torch.ops.spmm import spmm, spmm_reference
    if x.shape[-1] % 64 == 0:
        return (spmm_reference if plain else spmm)(op, x, out)
    res = csr_matmul(op, x)
    if out is None:
        return res
    out.copy_(res)
    return out


def apply_node_agg(ops, e: torch.Tensor) -> torch.Tensor:
    """The composed NodeBlock aggregation (JAX `models/gn_block.py`
    :110-112, `t[..., :h2] + u[..., h2:]` of two full-width applies):
    e [(B,) n_edges, h] -> [(B,) n_nodes, h/2], computed on the kept
    column windows only (see `_NodeAgg`)."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    return _NodeAgg.apply(e, ops, plain_versions_active())


def apply_node_pair(ops, y: torch.Tensor) -> torch.Tensor:
    """The composed NodeBlock aggregation in one pass (JAX
    `ops/blocksparse.py::apply_node_pair`): y [(B,) n_edges, 2h] ->
    [(B,) n_nodes, h]. The operand is cast to bf16 when `nbr_r` is stored
    bf16 and the output takes the type of that cast operand — so in the
    float32 configuration with bf16-stored operators the aggregation comes
    out bf16, as in JAX (a reference quirk, kept)."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    return _NodePair.apply(y, ops, plain_versions_active())


# ---------- host-side COO triplets of the standard mesh operators ----------


def gather_coo(idx: np.ndarray):
    """out[e] = x[idx[e]] — one-hot rows."""
    e = np.arange(idx.shape[0])
    return e, idx, np.ones(idx.shape[0], np.float32)


def signed_diff_coo(face_node: np.ndarray):
    """out[e] = x[s_e] − x[r_e] (relative edge features)."""
    s, r = face_node[0], face_node[1]
    e = np.arange(s.shape[0])
    rows = np.concatenate([e, e])
    cols = np.concatenate([s, r])
    vals = np.concatenate([np.ones_like(s, np.float32),
                           -np.ones_like(r, np.float32)])
    return rows, cols, vals
