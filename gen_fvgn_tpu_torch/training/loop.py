"""The data-free training loop.

Counterpart of `gen_fvgn_tpu/training/loop.py` (`train` :51-145,
`_train_block` :156-291, `_log_epoch` :34-49, `_log_param_histograms`
:148-153) on one device, over cases read from directories or given in
memory: outer epochs over the environment pool; `max_inner_steps` inner
train steps per epoch, the environments' new states paid back on the last;
then the boundary-condition re-roll of the oldest environments on the
reference's cadence, the wave sources, and the epoch counter that drives
the learning-rate schedule; one row of `Loss_monitor.dat` per epoch;
rotating 3-slot checkpoints every 50 epochs and at the last, each with a
parameter histogram where TensorBoard is on.

cfg.engine picks the engine. "segment" (the Config's default): batches cut
from one permutation of all environments of the one device-resident pool,
`make_train_step` (cfg.mixed_case_batches changes nothing there: its
batches mix the cases already; cfg.bucket_tiers raises). "block": per-case
(stratified) batches, which is what the JAX package's `pre_train` script
runs at its defaults, or mixed-case batches (cfg.mixed_case_batches,
`MixedTrainStepBlock`); cfg.bucket_tiers is a segment-engine option, which
the block loop ignores, as in JAX.

Inside an epoch nothing waits for the device but the log: `_log_epoch`
moves every scalar of the epoch to the host in one transfer.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.io.checkpoint import RotatingCheckpointer, load_state
from gen_fvgn_tpu_torch.io.logger import RunLogger
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


def _unported(cfg: Config) -> Optional[str]:
    if cfg.dp_devices > 1 or cfg.sp_devices > 1:
        return ("dp_devices / sp_devices > 1: data and spatial parallelism "
                "belong to a later slice of the port")
    return None


def train(
    cfg: Config,
    case_dirs: Sequence[str] = (),
    cases=None,
    log_base_dir: str = "runs",
    seed: int = 0,
    n_epochs: Optional[int] = None,
    resume_from: Optional[str] = None,
    logger: Optional[RunLogger] = None,
    use_tensorboard: bool = False,
    device="cuda",
) -> TrainState:
    """Train cfg.net on cfg.engine over the pool of `cases`, or of the cases
    read from `case_dirs` (`training/pool.py::load_case`), for `n_epochs`
    (default cfg.n_epochs) epochs; returns the final TrainState. The run
    directory (loss monitor, checkpoints, exports, TensorBoard events) is
    made under `log_base_dir` unless `logger` is given. `resume_from` names
    a checkpoint slot to start from. device="cuda" without a card raises;
    options of the JAX loop that the port does not carry yet raise
    NotImplementedError. (The JAX loop draws a first batch to shape its
    parameters; the port's modules know their shapes from cfg, so none is
    drawn.)"""
    why = _unported(cfg)
    if why:
        raise NotImplementedError(why)
    dev = resolve_device(device)
    n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
    block = cfg.engine == "block"
    pool = EnvPool(case_dirs, cfg, seed=seed, cases=cases, engine=cfg.engine,
                   tile=cfg.tile, bucket_tiers=cfg.bucket_tiers and not block,
                   device=dev)
    cfg = cfg.replace(dataset_size=len(pool))
    init = init_train_state_block if block else init_train_state
    state, simulator = init(cfg, seed=seed, device=dev)
    if resume_from is not None:
        state = load_state(resume_from, like=state)
    inner = (_block_inner(cfg, pool, simulator, dev) if block
             else _segment_inner(cfg, pool, simulator, dev))

    own_logger = logger is None
    if own_logger:
        logger = RunLogger(log_base_dir, cfg, seed=seed,
                           use_tensorboard=use_tensorboard)
    try:
        return _epochs(cfg, pool, state, inner, logger, n_epochs)
    finally:
        if own_logger:
            logger.close()


def _segment_inner(cfg, pool, simulator, dev):
    """One inner iteration of the segment loop: a train step on every batch
    of the step's permutation, paid back where asked."""
    step = make_train_step(cfg, simulator, device=dev)

    def inner(state, train_steps, payback):
        last = None
        for idxs in pool.batch_indices(step_seed=train_steps):
            state, last, uvp_new = step(state, pool.gather_batch(idxs))
            if payback:
                pool.payback(idxs, uvp_new)
        return state, last
    return inner


def _block_inner(cfg, pool, simulator, dev):
    """One inner iteration of the block loop against the shared per-case
    StaticPacks: batches of one case each, or with cfg.mixed_case_batches
    drawn across the cases and run as `MixedTrainStepBlock`."""
    step = make_train_step_block(cfg, simulator, device=dev)
    mixed = (MixedTrainStepBlock(cfg, simulator, device=dev)
             if cfg.mixed_case_batches else None)

    def inner(state, train_steps, payback):
        last = None
        if mixed is not None:
            for batch in pool.mixed_block_batches(step_seed=train_steps):
                state, last = mixed.run_batch(
                    state, batch, pool.gather_block, pool.statics,
                    payback=pool.payback_block if payback else None)
            return state, last
        for ci, idxs in pool.block_batches(step_seed=train_steps):
            state, last, uvp_new = step(state, pool.gather_block(idxs),
                                        pool.statics[ci])
            if payback:
                pool.payback_block(idxs, uvp_new)
        return state, last
    return inner


def _epochs(cfg, pool, state, inner, logger, n_epochs):
    ckpt = RotatingCheckpointer(logger.states_dir)

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

        export_dir = logger.results_dir if cfg.export_on_reset else None
        for _ in range(reset_pending):
            pool.reset_env(export_dir=export_dir)
        reset_pending = 0

        if pool.has_wave_envs():
            pool.inject_wave_sources()

        state.epoch += 1

        if last_metrics is not None:
            _log_epoch(logger, epoch, last_metrics, t0)
        if epoch % 50 == 0 or epoch == n_epochs - 1:
            ckpt.save(state, epoch)
            _log_param_histograms(logger, state, epoch)

    return state
