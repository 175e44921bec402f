"""Data parallelism over the default `torch.distributed` process group.

Counterpart of `gen_fvgn_tpu/parallel/dp.py`. There one process drives
`dp_devices` devices through a sharded `jit`, and XLA places the gradient
`psum`. Here every rank is one process on one device; every rank holds the
same pool and the same parameters, takes its own contiguous rows of the
global batch, and the collectives are explicit:

| JAX (`gen_fvgn_tpu/parallel/dp.py`)   | port                                  |
|---------------------------------------|---------------------------------------|
| `make_mesh`                           | the process group (`multihost.initialize`, `multihost.world`) |
| `shard_batch`, `shard_block_batch`    | `local_rows` (the rank's rows of the batch axis) |
| `shard_train_state`, `shard_static`   | `broadcast_state` (rank 0's parameters, Adam state and normalizer to every rank); the statics are built alike on every rank |
| the gradient `psum` XLA inserts        | `all_reduce_grads` (one flat buffer, one `all_reduce` a step) |
| the batch sums inside the jitted step | `all_reduce_sum` (the normalizer's sums, the metrics) |
| an output sharded over dp             | `all_gather_rows` (the global `[B, ...]` on every rank, where the pool is paid back) |

Every collective is an `all_reduce` or a `broadcast`, the two that gloo
offers on CUDA tensors, so one code path serves gloo on the CPU, gloo on
CUDA and NCCL. Without a process group each function is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch
import torch.distributed as dist

from gen_fvgn_tpu_torch.parallel.multihost import local_batch_rows, world


def local_rows(data, global_b: int, process_id=None, process_count=None):
    """This rank's contiguous block of the leading (batch) axis of `data`:
    a tensor or array, or a dataclass (MeshSample, DynamicPack) whose
    fields with leading size `global_b` are cut and whose other fields are
    kept. `process_id` / `process_count` (default: the rank and the world
    size) place the rank on the batch axis; under dp × sp they are its dp
    index and dp_devices (`parallel/sp.py::SpLayout`)."""
    rows = local_batch_rows(global_b, process_id, process_count)
    lo, hi = int(rows[0]), int(rows[-1]) + 1

    def cut(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == global_b:
            return x[lo:hi]
        return x
    if dataclasses.is_dataclass(data):
        return dataclasses.replace(data, **{
            f.name: cut(getattr(data, f.name))
            for f in dataclasses.fields(data)})
    return cut(data)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor (`t` is kept)."""
    if not dist.is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks (equal weights)."""
    return all_reduce_sum(t) / world()[1]


def all_reduce_grads(grads: Sequence[torch.Tensor],
                     scale: float) -> List[torch.Tensor]:
    """Σ over the ranks of every gradient, times `scale`, through ONE flat
    buffer and one `all_reduce` (not one per parameter). Returns views of
    the buffer in the shapes of `grads`. The gradients must share a
    dtype (the nets' parameters are float32)."""
    if not dist.is_initialized():
        return list(grads) if scale == 1.0 else [g * scale for g in grads]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    if scale != 1.0:
        flat.mul_(scale)
    return [piece.view(g.shape) for piece, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def all_gather_rows(local: torch.Tensor, global_b: int) -> torch.Tensor:
    """The global `[global_b, ...]` tensor on every rank from each rank's
    `local_rows` block: each rank writes its block into a zero buffer and
    one `all_reduce` sums them. Exact (x + 0 = x), and it needs no
    `all_gather`, which gloo lacks on CUDA tensors."""
    if not dist.is_initialized():
        return local
    rows = local_batch_rows(global_b)
    out = torch.zeros((global_b,) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    out[int(rows[0]):int(rows[-1]) + 1] = local.detach()
    dist.all_reduce(out)
    return out


def _state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a TrainState, in the same order on every rank:
    parameters, the normalizer, the optimizer's state per parameter."""
    from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
    out = [p.data for p in state.simulator.parameters()]
    out += [getattr(state.norm_state, f.name)
            for f in dataclasses.fields(NormalizerState)]
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:
        st = state.optimizer.state.get(p, {})
        out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    return out


def broadcast_state(state, src: int = 0):
    """Rank `src`'s parameters, Adam state, normalizer, step and epoch on
    every rank, in place (after init and after a resume). One `broadcast`
    per dtype: the tensors are packed into a flat buffer on the
    parameters' device (Adam keeps its step counts on the host, NCCL
    takes device tensors only)."""
    if not dist.is_initialized():
        return state
    dev = next(state.simulator.parameters()).device
    tensors = _state_tensors(state)
    counters = torch.tensor([state.step, state.epoch], dtype=torch.int64)
    tensors.append(counters)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.cat([t.detach().reshape(-1).to(dev) for t in group])
        dist.broadcast(flat, src=src)
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            with torch.no_grad():
                t.copy_(piece.view(t.shape))
    state.step, state.epoch = int(counters[0]), int(counters[1])
    return state


def require_group() -> int:
    """The world size of the default process group, which a data-parallel
    step reduces over; RuntimeError where there is none."""
    if not dist.is_initialized():
        raise RuntimeError("a data-parallel step needs an initialised "
                           "torch.distributed process group "
                           "(parallel.multihost.initialize)")
    return world()[1]


def check_world(dp_devices: int) -> int:
    """The world size for `dp_devices` > 1: an initialised process group
    of exactly that size, else a RuntimeError that says how to launch.
    The port never falls back to one process."""
    size = world()[1]
    if size != dp_devices:
        raise RuntimeError(
            f"dp_devices={dp_devices} needs a torch.distributed process "
            f"group of world size {dp_devices} (found "
            f"{'none' if not dist.is_initialized() else size}): launch under "
            f"torchrun --nproc_per_node {dp_devices}, or initialise the "
            f"group with parallel.multihost.initialize first")
    return size

