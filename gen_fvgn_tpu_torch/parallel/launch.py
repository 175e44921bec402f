"""Ranks on one machine without a launcher: `spawn(fn, world_size, ...)`
starts `world_size` processes with the `spawn` start method, each joins a
process group through a `file://` store (no TCP port, so that concurrent
runs cannot collide), runs `fn(rank, world_size, *args)`, and leaves the
group. The parent returns every rank's result. torchrun is the launcher of
record (`scripts/pre_train.py --dp-devices N`, `--sp-devices N`); this
serves the tests, the dry run and `chip_smoke.py`. `rank_group` is the
CLIs' side of a launch: the process group a script joins, checked against
the grid it was asked for.

`fn` must be importable by name in a fresh interpreter (a module-level
function), and so must its arguments be picklable.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               store: str, out_dir: str, args: tuple) -> None:
    from gen_fvgn_tpu_torch.parallel.multihost import initialize
    torch.set_num_threads(1)
    initialize(backend=backend, init_method=f"file://{store}",
               world_size=world_size, rank=rank)
    try:
        result = fn(rank, world_size, *args)
        dist.barrier()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def _join(ctx, tmp: str, world_size: int) -> bool:
    """`ctx.join` for a second; where a rank failed, a RuntimeError with
    every failed rank's traceback (the first rank to fail may not be the
    lowest, and the others then fail in their collectives)."""
    try:
        return ctx.join(timeout=1.0)
    except ProcessException as exc:
        errs = []
        for r in range(world_size):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                errs.append(f"--- rank {r}:\n" + open(path).read())
        raise RuntimeError("a spawned rank failed:\n" + "\n".join(errs)
                           if errs else str(exc)) from exc


def spawn(fn: Callable, world_size: int, *args: Any, backend: str = "gloo",
          timeout: float = 600.0,
          workdir: Optional[str] = None) -> List[Any]:
    """Run `fn(rank, world_size, *args)` on `world_size` spawned ranks of a
    `backend` process group; returns the ranks' results in rank order. A
    rank that raises fails the whole run (the others are stopped) with its
    traceback; a run longer than `timeout` seconds is stopped and raises
    TimeoutError."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, store, tmp, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not _join(ctx, tmp, world_size):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"ran past {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]


@contextlib.contextmanager
def rank_group(dp_devices: int, sp_devices: int, device: str):
    """The process group of dp_devices × sp_devices ranks (joined here from
    the launcher's environment unless this process has one already, and
    left on exit if joined here), yielding the rank's device: "cuda" is
    cuda:LOCAL_RANK, which must exist (two ranks share a card only where
    `device` names it); any other name is taken as given. A world size
    other than dp_devices × sp_devices raises RuntimeError, naming both,
    before anything is read."""
    from gen_fvgn_tpu_torch.parallel import dp, multihost, sp
    ours = not dist.is_initialized()
    multihost.initialize(device=device)
    try:
        if sp_devices > 1:
            sp.check_world(dp_devices, sp_devices)
        else:
            dp.check_world(dp_devices)
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} but {torch.cuda.device_count()} "
                    f"CUDA device(s): one rank a card, or name the card "
                    f"with --device")
            device = f"cuda:{local}"
            torch.cuda.set_device(device)
        yield device
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()
