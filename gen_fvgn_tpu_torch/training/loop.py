"""The data-free training loop.

Counterpart of `gen_fvgn_tpu/training/loop.py` (`train` :51-145,
`_train_block` :156-291, `_log_epoch` :34-49, `_log_param_histograms`
:148-153), over cases read from directories or given in memory: outer
epochs over the environment pool; `max_inner_steps` inner train steps per
epoch, the environments' new states paid back on the last; then the
boundary-condition re-roll of the oldest environments on the reference's
cadence, the wave sources, and the epoch counter that drives the
learning-rate schedule; one row of `Loss_monitor.dat` every
`progress_every` epochs; rotating 3-slot checkpoints every 50 epochs and
at the last, each with a parameter histogram where TensorBoard is on.

cfg.engine picks the engine. "segment" (the Config's default): batches cut
from one permutation of all environments of the one device-resident pool,
or with cfg.bucket_tiers within each per-size tier of it, all through one
`make_train_step` callable (cfg.mixed_case_batches changes nothing there:
its batches mix the cases already). "block": per-case
(stratified) batches, which is what the JAX package's `pre_train` script
runs at its defaults, or mixed-case batches (cfg.mixed_case_batches,
`MixedTrainStepBlock`); cfg.bucket_tiers is a segment-engine option, which
the block loop ignores, as in JAX.

Inside an epoch nothing waits for the device but the log: `_log_epoch`
moves every scalar of the epoch to the host in one transfer.

Data parallelism (cfg.dp_devices > 1; JAX `training/loop.py:83-97`,
`:219-269`): one process a rank under an initialised `torch.distributed`
group of exactly dp_devices ranks (torchrun; `parallel/multihost.py`),
never one process. Every rank builds the same pool on its own device
(the same seed, draws and re-rolls: the JAX segment loop's host pool under
dp is for one process feeding many devices), takes its rows of every
batch, and pays back the global batch's states, which the dp steps return
on every rank. Rank 0's parameters and Adam state go to every rank after
init and resume. Only rank 0 makes the run directory: the loss monitor,
checkpoints and exports.

Spatial parallelism (cfg.sp_devices > 1, the block engine only; JAX
`training/loop.py:66-81`, `:169-217`): dp_devices × sp_devices ranks, each
on the (dp, sp) grid of `parallel.sp.groups`. The pool pads every entity
to tile × sp_devices rows; every rank builds the whole pool and cuts its
rows of every case's statics (`parallel.sp.shard_static_sp`) and of every
batch (its batch rows over dp, its node rows over sp), and the global
batch's states come back to every rank for the payback
(`parallel.sp.gather_states`). The segment engine under sp raises JAX's
ValueError.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.io.checkpoint import RotatingCheckpointer, load_state
from gen_fvgn_tpu_torch.io.logger import RunLogger
from gen_fvgn_tpu_torch.parallel import dp as dp_mod
from gen_fvgn_tpu_torch.parallel import multihost
from gen_fvgn_tpu_torch.parallel import sp as sp_mod
from gen_fvgn_tpu_torch.training.pool import EnvPool
from gen_fvgn_tpu_torch.training.train import (TrainState,
                                               init_train_state,
                                               make_train_step)
from gen_fvgn_tpu_torch.training.train_block import (MixedTrainStepBlock,
                                                     init_train_state_block,
                                                     make_train_step_block)
from gen_fvgn_tpu_torch.utils.device import resolve_device


def _log_epoch(logger, epoch, last_metrics, t0):
    """The epoch's scalars to the host in ONE transfer (a stack, then one
    copy), then one row of the loss monitor."""
    vals = torch.stack([
        last_metrics.loss, last_metrics.loss_cont, last_metrics.loss_mom,
        last_metrics.loss_press, last_metrics.grad_norm]).cpu().numpy()
    logger.log_scalars(epoch, {
        "loss": float(vals[0]),
        "loss_cont": float(vals[1]),
        "loss_mom": float(vals[2]),
        "loss_press": float(vals[3]),
        "grad_norm": float(vals[4]),
        "lr": float(last_metrics.lr),
        "epoch_seconds": time.time() - t0,
    })


def _log_param_histograms(logger, state, epoch):
    """The parameter histogram at the checkpoint cadence (nothing where
    TensorBoard is off)."""
    logger.log_param_histogram(state.simulator, epoch)


def train(
    cfg: Config,
    case_dirs: Sequence[str] = (),
    cases=None,
    log_base_dir: str = "runs",
    seed: int = 0,
    n_epochs: Optional[int] = None,
    resume_from: Optional[str] = None,
    pad_multiple: int = 128,
    progress_every: int = 1,
    logger: Optional[RunLogger] = None,
    use_tensorboard: bool = False,
    device="cuda",
) -> TrainState:
    """Train cfg.net on cfg.engine over the pool of `cases`, or of the cases
    read from `case_dirs` (`training/pool.py::load_case`), for `n_epochs`
    (default cfg.n_epochs) epochs; returns the final TrainState. The pool
    pads to multiples of `pad_multiple` (the block engine to at least its
    tile); the loss monitor takes a row every `progress_every` epochs. The
    run directory (loss monitor, checkpoints, exports, TensorBoard events)
    is made under `log_base_dir` unless `logger` is given; under data
    parallelism on rank 0 only (the other ranks ignore `logger`).
    `resume_from` names a checkpoint slot to start from. device="cuda"
    without a card raises; cfg.dp_devices > 1 (or dp_devices ×
    sp_devices > 1) without a process group of that size raises
    RuntimeError; cfg.sp_devices > 1 on the segment engine raises
    ValueError, as in JAX. (The JAX loop draws a first batch to shape its
    parameters; the port's modules know their shapes from cfg, so none is
    drawn.)"""
    block = cfg.engine == "block"
    if cfg.sp_devices > 1 and not block:
        raise ValueError("sp_devices > 1 requires engine='block' (the "
                         "segment engine has no sharded-operator form)")
    dp = cfg.dp_devices > 1
    lay = None
    if cfg.sp_devices > 1:
        lay = sp_mod.groups(max(cfg.dp_devices, 1), cfg.sp_devices)
    elif dp:
        dp_mod.check_world(cfg.dp_devices)
    if dp and cfg.batch_size % cfg.dp_devices:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"dp_devices {cfg.dp_devices}")
    dev = resolve_device(device)
    n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
    pool = EnvPool(case_dirs, cfg, seed=seed, pad_multiple=pad_multiple,
                   cases=cases, engine=cfg.engine, tile=cfg.tile,
                   bucket_tiers=cfg.bucket_tiers and not block, device=dev)
    cfg = cfg.replace(dataset_size=len(pool))
    init = init_train_state_block if block else init_train_state
    state, simulator = init(cfg, seed=seed, device=dev)
    if resume_from is not None:
        state = load_state(resume_from, like=state)
    if dp or lay is not None:
        dp_mod.broadcast_state(state)
    inner = (_block_inner(cfg, pool, simulator, dev, dp, lay) if block
             else _segment_inner(cfg, pool, simulator, dev, dp))

    rank0 = multihost.world()[0] == 0
    own_logger = logger is None and rank0
    if own_logger:
        logger = RunLogger(log_base_dir, cfg, seed=seed,
                           use_tensorboard=use_tensorboard)
    try:
        return _epochs(cfg, pool, state, inner,
                       logger if rank0 else None, n_epochs, progress_every)
    finally:
        if own_logger:
            logger.close()


def _mine(idxs, dp: bool, lay=None):
    """The environments of a batch this process runs: all of them, or
    under data parallelism the rank's contiguous block (under dp × sp the
    block of its dp index)."""
    if not dp:
        return idxs
    at = (dict(process_id=lay.dp_index, process_count=lay.dp)
          if lay is not None else {})
    return dp_mod.local_rows(idxs, len(idxs), **at)


def _global(uvp_new, idxs, dp: bool, lay=None):
    """The new states of the whole batch `idxs` for the payback: a dp or
    sp step's rows gathered from every rank."""
    if lay is not None:
        return sp_mod.gather_states(uvp_new, len(idxs), lay)
    return dp_mod.all_gather_rows(uvp_new, len(idxs)) if dp else uvp_new


def _segment_inner(cfg, pool, simulator, dev, dp):
    """One inner iteration of the segment loop: a train step on every batch
    of the step's permutation, paid back where asked."""
    step = make_train_step(cfg, simulator, device=dev, dp=dp)

    def inner(state, train_steps, payback):
        last = None
        for idxs in pool.batch_indices(step_seed=train_steps):
            state, last, uvp_new = step(
                state, pool.gather_batch(_mine(idxs, dp)))
            if payback:
                pool.payback(idxs, _global(uvp_new, idxs, dp))
        return state, last
    return inner


def _block_inner(cfg, pool, simulator, dev, dp, lay=None):
    """One inner iteration of the block loop against the shared per-case
    StaticPacks (under sp the rank's cuts of them): batches of one case
    each, or with cfg.mixed_case_batches drawn across the cases and run as
    `MixedTrainStepBlock`."""
    sp = lay is not None
    step = make_train_step_block(cfg, simulator, device=dev, dp=dp, sp=sp)
    mixed = (MixedTrainStepBlock(cfg, simulator, device=dev, dp=dp, sp=sp)
             if cfg.mixed_case_batches else None)
    statics = ([sp_mod.shard_static_sp(s, lay.sp, lay.sp_index)
                for s in pool.statics] if sp else pool.statics)

    def inner(state, train_steps, payback):
        last = None
        if mixed is not None:
            for batch in pool.mixed_block_batches(
                    step_seed=train_steps, n_dev=max(cfg.dp_devices, 1)):
                state, last = mixed.run_batch(
                    state, batch, pool.gather_block, statics,
                    payback=pool.payback_block if payback else None)
            return state, last
        for ci, idxs in pool.block_batches(step_seed=train_steps):
            dyn = pool.gather_block(_mine(idxs, dp, lay))
            if sp:
                dyn = sp_mod.local_rows_sp(dyn, lay)
            state, last, uvp_new = step(state, dyn, statics[ci])
            if payback:
                pool.payback_block(idxs, _global(uvp_new, idxs, dp, lay))
        return state, last
    return inner


def _epochs(cfg, pool, state, inner, logger, n_epochs, progress_every):
    """The epochs; `logger` None (a rank other than 0) writes nothing."""
    ckpt = RotatingCheckpointer(logger.states_dir) if logger else None

    train_steps = 0
    reset_pending = 0
    reset_every = max(1, math.ceil(cfg.average_sequence_length / len(pool)))
    rst_time = max(1, math.ceil(len(pool) / cfg.average_sequence_length))

    for epoch in range(n_epochs):
        t0 = time.time()
        if epoch % reset_every == 0 and epoch > 0:
            reset_pending = rst_time

        last_metrics = None
        for i_iter in range(cfg.max_inner_steps):
            train_steps += 1
            state, metrics = inner(state, train_steps,
                                   payback=i_iter == cfg.max_inner_steps - 1)
            last_metrics = metrics if metrics is not None else last_metrics

        export_dir = (logger.results_dir
                      if cfg.export_on_reset and logger else None)
        for _ in range(reset_pending):
            pool.reset_env(export_dir=export_dir)
        reset_pending = 0

        if pool.has_wave_envs():
            pool.inject_wave_sources()

        state.epoch += 1

        if logger is None:
            continue
        if last_metrics is not None and epoch % progress_every == 0:
            _log_epoch(logger, epoch, last_metrics, t0)
        if epoch % 50 == 0 or epoch == n_epochs - 1:
            ckpt.save(state, epoch)
            _log_param_histograms(logger, state, epoch)

    return state
