"""Process-group glue for data-parallel training.

Counterpart of `gen_fvgn_tpu/parallel/multihost.py`. The JAX package runs
one process per host, each driving its local devices, over a global device
mesh. The port runs one process per rank, each on one device, under
`torch.distributed`; the process group is the mesh:

* `initialize()` wraps `torch.distributed.init_process_group` (a no-op
  where nothing asks for more than one rank, or where a group exists);
* `world()` gives (rank, world size), (0, 1) without a group; it stands in
  for `global_mesh`;
* `host_shard(items)` and `local_batch_rows(global_batch)` are the JAX
  functions, on the group's rank and size.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch
import torch.distributed as dist

T = TypeVar("T")


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device="cuda") -> Tuple[int, int]:
    """Initialize the default process group and return `world()`.

    No-op where a group already exists, and where nothing asks for more
    than one rank: no `init_method`, `world_size` unset or 1, and no
    launcher environment (`WORLD_SIZE`, which torchrun sets). Otherwise
    `init_method` defaults to "env://" (torchrun's MASTER_ADDR /
    MASTER_PORT / RANK / WORLD_SIZE). `backend=None` is NCCL for a CUDA
    `device` and gloo for the CPU; gloo on CUDA tensors (which offers
    `all_reduce` and `broadcast`, all that `dp.py` uses) must be asked
    for."""
    if dist.is_initialized():
        return world()
    if init_method is None and world_size in (None, 1) \
            and "WORLD_SIZE" not in os.environ:
        return world()
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)     # the rank's card for NCCL's streams
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    return world()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_shard(items: Sequence[T],
               process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> List[T]:
    """Deterministic per-rank slice of a sequence (cases, env indices):
    round-robin by rank, so every rank gets ⌈N/P⌉ or ⌊N/P⌋ items and the
    union over ranks is exactly the input."""
    rank, size = world()
    pid = rank if process_id is None else process_id
    pcount = size if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pcount == pid]


def local_batch_rows(global_batch: int,
                     process_id: Optional[int] = None,
                     process_count: Optional[int] = None) -> np.ndarray:
    """Row indices of the global batch this rank feeds (contiguous blocks:
    rank p owns rows [p·B/P, (p+1)·B/P), the layout of a dp-sharded
    leading axis)."""
    rank, size = world()
    pid = rank if process_id is None else process_id
    pcount = size if process_count is None else process_count
    if global_batch % pcount:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"process count {pcount}")
    per = global_batch // pcount
    return np.arange(pid * per, (pid + 1) * per)
