"""Spatial parallelism (sp): one mesh cut by rows over the ranks of a
`torch.distributed` group.

Counterpart of `gen_fvgn_tpu/parallel/sp.py`. There one process drives a
2-D `(dp, sp)` device mesh through GSPMD: every static operator of the
block engine is sharded on its output rows, every entity array (nodes,
faces, cells) on its rows, and XLA inserts the collectives. Here every
rank is one process, rank = d·sp + s on the grid `make_dp_sp_mesh` lays
out (sp innermost), and the collectives are explicit:

| JAX (`gen_fvgn_tpu/parallel/sp.py`)    | port                                  |
|----------------------------------------|---------------------------------------|
| `make_dp_sp_mesh`                      | `groups(dp, sp)`: the world check, the sp subgroups (`SpLayout`) |
| `_put`'s row sharding                  | `entity_rows` (raises where the rows do not divide: the pool pads every entity to tile·sp) |
| `shard_static_sp`                      | `shard_static_sp`: every operator direction and entity static cut to the rank's rows |
| `shard_block_batch_dp`                 | `dp.local_rows` (the batch over dp) and `local_rows_sp` (the nodes over sp) |
| `replicate_state`                      | `dp.broadcast_state` (rank 0's state on every rank) |
| `sp_kernel_context`, `blocksparse.set_sp_mesh` | `sp_context` (`ops/blocksparse.py::set_sp_group`): every apply runs on the rank's rows of the all-gathered operand |
| `single_device_kernels_disabled`       | none: every kernel runs on the rank's rows |
| GSPMD's all-gather of an apply's operand | `all_gather_rows_sp` (inside `apply_linop` and its backward) |
| GSPMD's psums of the masked sums       | `sp_sum` (an all-reduce whose backward is an all-reduce) |
| an output sharded over (dp, sp)        | `gather_states` (the global `[B, N, ...]` on every rank) |

An operator direction [n_out ← n_in] keeps its output rows [lo, hi) of the
rank, with `crow` rebased to 0, `col` global and `take_idx` cut to the same
rows: `fwd` on the output space, `bwd` (the stored transpose) on the input
space. The apply gathers the operand's rows over the sp group and applies
the rank's block, and its backward gathers the cotangent and applies the
rank's `bwd` block, so every output row is summed by one rank in the
unsharded order. The WLSQ operator's rows are node·n_q + q, so a rank's
nodes' n_q rows each form its block.

Every collective is an `all_reduce` (gloo offers `all_reduce` and
`broadcast` on CUDA tensors): an all-gather is the rank's rows written
into a zero buffer and one `all_reduce`, which is exact (x + 0 = x), so one
code path serves gloo on the CPU, gloo on CUDA and NCCL.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from gen_fvgn_tpu_torch.ops import blocksparse as bs
from gen_fvgn_tpu_torch.ops.blocksparse import CsrOp, LinOp
from gen_fvgn_tpu_torch.parallel.multihost import local_batch_rows, world


@dataclass(frozen=True)
class SpLayout:
    """This rank's place on the (dp, sp) grid: rank = dp_index·sp +
    sp_index. `sp_group` holds the ranks that share this rank's batch rows
    (one mesh cut sp ways); None stands for the default group (where the
    sp group is the whole world) or for no group at all (one process).
    Every other collective runs over the world: the gradients, the
    normalizer's sums, the metrics and `gather_states`."""
    dp: int
    sp: int
    dp_index: int
    sp_index: int
    sp_group: Any = None


_GROUPS = {}
_LAYOUT: Optional[SpLayout] = None


def check_world(dp: int, sp: int) -> int:
    """The world size for a dp × sp run: an initialised process group of
    exactly dp·sp ranks where that is above 1, else a RuntimeError naming
    both and how to launch. The port never runs sp on one process."""
    n = dp * sp
    size = world()[1]
    if size != n or (n > 1 and not dist.is_initialized()):
        raise RuntimeError(
            f"dp_devices={dp} x sp_devices={sp} needs a torch.distributed "
            f"process group of world size {n} (found "
            f"{'none' if not dist.is_initialized() else size}): launch under "
            f"torchrun --nproc_per_node {n}, or initialise the group with "
            f"parallel.multihost.initialize first")
    return size


def groups(dp: int, sp: int) -> SpLayout:
    """This rank's `SpLayout` on the (dp, sp) grid, made the current one
    (`layout()`). Under dp > 1 the first call for a grid creates the sp
    subgroups with `dist.new_group`; every rank must make it, in the same
    order as every other rank, since group creation is collective."""
    global _LAYOUT
    check_world(dp, sp)
    rank = world()[0]
    key = (dp, sp, id(dist.group.WORLD) if dist.is_initialized() else None)
    if key not in _GROUPS:
        sp_group = None
        if dist.is_initialized() and dp > 1 and sp > 1:
            for d in range(dp):
                g = dist.new_group([d * sp + s for s in range(sp)])
                if rank // sp == d:
                    sp_group = g
        _GROUPS[key] = SpLayout(dp=dp, sp=sp, dp_index=rank // sp,
                                sp_index=rank % sp, sp_group=sp_group)
    _LAYOUT = _GROUPS[key]
    return _LAYOUT


def layout() -> SpLayout:
    """The layout the last `groups()` made; RuntimeError before any."""
    if _LAYOUT is None:
        raise RuntimeError("no sp layout: call parallel.sp.groups(dp, sp) "
                           "on every rank first")
    return _LAYOUT


@contextlib.contextmanager
def sp_context(lay: Optional[SpLayout] = None):
    """Every apply, masked sum and slice pool inside runs on this rank's
    rows of `lay` (default: the current layout) with its sums all-reduced
    over the sp group (`ops/blocksparse.py::set_sp_group`); the previous
    setting comes back on exit."""
    lay = lay or layout()
    old = bs.sp_layout()
    bs.set_sp_group(lay)
    try:
        yield lay
    finally:
        bs.set_sp_group(old)


def entity_rows(n_pad: int, sp: int, index: int) -> Tuple[int, int]:
    """Rank `index`'s contiguous block [lo, hi) of `n_pad` rows cut `sp`
    ways; ValueError where they do not divide (the JAX package replicates
    such an array instead, but the port's pool pads every entity to
    tile·sp rows, so a remainder is a fault)."""
    if n_pad % sp:
        raise ValueError(f"{n_pad} rows do not divide over {sp} sp ranks: "
                         f"pad every entity to a multiple of tile x "
                         f"sp_devices")
    per = n_pad // sp
    return index * per, (index + 1) * per


def cut_rows(op: CsrOp, lo: int, hi: int) -> CsrOp:
    """Rows [lo, hi) of one operator direction: `crow` rebased to 0, `col`
    global (the apply reads the gathered operand), `take_idx` cut alike."""
    crow = op.crow[lo:hi + 1]
    start, end = int(crow[0]), int(crow[-1])
    return CsrOp(crow=(crow - start).contiguous(),
                 col=op.col[start:end].clone(), val=op.val[start:end].clone(),
                 n_out=hi - lo, n_in=op.n_in, dtype=op.dtype,
                 take_idx=None if op.take_idx is None
                 else op.take_idx[lo:hi].clone())


def shard_static_sp(static, sp: int, index: int):
    """`static` (a StaticPack) with every operator direction cut to rank
    `index`'s output rows of `sp` and every entity-indexed static (pos,
    node_type, node_mask, cells_area, edge_pos_feat, deg, face_inflow,
    face_wall, s_out) to its rows. Two operators that share a direction
    (gsadj / gradj are nbr_s / nbr_r transposed) share its cut."""
    ops = static.ops
    n_pad = static.pos.shape[0]
    if ops.wlsq.fwd.n_out != n_pad * ops.wlsq_n_q:
        raise ValueError(f"the WLSQ operator has {ops.wlsq.fwd.n_out} rows, "
                         f"not {n_pad} nodes x {ops.wlsq_n_q}: pad the nodes "
                         f"to a multiple of the tile")
    done = {}

    def cut(op: CsrOp) -> CsrOp:
        if id(op) not in done:
            done[id(op)] = cut_rows(op, *entity_rows(op.n_out, sp, index))
        return done[id(op)]

    def rows(t: torch.Tensor) -> torch.Tensor:
        lo, hi = entity_rows(t.shape[0], sp, index)
        return t[lo:hi].clone()

    new_ops = {}
    for f in dataclasses.fields(ops):
        v = getattr(ops, f.name)
        if isinstance(v, LinOp):
            new_ops[f.name] = LinOp(fwd=cut(v.fwd), bwd=cut(v.bwd))
        elif torch.is_tensor(v):
            new_ops[f.name] = rows(v)
    return dataclasses.replace(
        static, ops=dataclasses.replace(ops, **new_ops),
        **{f.name: rows(getattr(static, f.name))
           for f in dataclasses.fields(static) if f.name != "ops"})


def local_rows_sp(dyn, lay: Optional[SpLayout] = None):
    """This rank's node rows of every [B, N, ...] field of a DynamicPack
    (uvp, target_uv); the per-sample fields are kept."""
    lay = lay or layout()
    if lay.sp == 1:
        return dyn

    def cut(x):
        if getattr(x, "ndim", 0) != 3:
            return x
        lo, hi = entity_rows(x.shape[1], lay.sp, lay.sp_index)
        return x[:, lo:hi]
    return dataclasses.replace(dyn, **{
        f.name: cut(getattr(dyn, f.name)) for f in dataclasses.fields(dyn)})


def all_gather_rows_sp(local: torch.Tensor,
                       lay: Optional[SpLayout] = None) -> torch.Tensor:
    """The whole [..., n·sp, F] on every rank of the sp group from each
    rank's rows [..., n, F] (the row axis is the second last, as in an
    apply's operand): each rank writes its rows into a zero buffer and one
    `all_reduce` over the sp group sums them. The counterpart of
    `dp.all_gather_rows`."""
    lay = lay or layout()
    if lay.sp == 1:
        return local
    n = local.shape[-2]
    out = local.new_zeros(local.shape[:-2] + (n * lay.sp,)
                          + local.shape[-1:])
    out[..., lay.sp_index * n:(lay.sp_index + 1) * n, :] = local.detach()
    dist.all_reduce(out, group=lay.sp_group)
    return out


def gather_states(local: torch.Tensor, global_b: int,
                  lay: Optional[SpLayout] = None) -> torch.Tensor:
    """The global [global_b, n·sp, ...] on every rank from each rank's
    block of batch rows (over dp) and entity rows (over sp), through one
    `all_reduce` over the world: what `all_gather_rows_sp` and then
    `dp.all_gather_rows` give, in one collective. For the payback."""
    lay = lay or layout()
    if not dist.is_initialized() or lay.dp * lay.sp == 1:
        return local
    b_rows = local_batch_rows(global_b, lay.dp_index, lay.dp)
    n = local.shape[1]
    out = local.new_zeros((global_b, n * lay.sp) + tuple(local.shape[2:]))
    out[int(b_rows[0]):int(b_rows[-1]) + 1,
        lay.sp_index * n:(lay.sp_index + 1) * n] = local.detach()
    dist.all_reduce(out)
    return out


class _SpSum(torch.autograd.Function):
    """Σ over the sp group, differentiable: the backward all-reduces the
    cotangent too (as `torch.distributed.nn.functional.all_reduce` does).
    Every rank then holds the same loss, each rank's gradient of a
    parameter is its rows' share times sp, and the step's world sum of the
    gradients takes the scale 1 / (dp·sp)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sp_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the sp group of the active `sp_context` (the masked
    sums of norm_uvp, the slice pool's tokens, the FV losses' sums before
    their square roots); `t` itself outside one."""
    lay = bs.sp_layout()
    if lay is None:
        return t
    return _SpSum.apply(t, lay.sp_group)
