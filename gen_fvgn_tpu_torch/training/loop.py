"""The data-free training loop of the block engine.

Counterpart of `gen_fvgn_tpu/training/loop.py` (`train` :51-78,
`_train_block` :156-291, `_log_epoch` :34-49, `_log_param_histograms`
:148-153) on one device, over cases read from directories or given in
memory, with per-case (stratified) batches, which is what the JAX
package's `pre_train` script runs at the Config defaults, or with
mixed-case batches (cfg.mixed_case_batches, `MixedTrainStepBlock`):
outer epochs over the environment pool; `max_inner_steps` inner train
steps per epoch, the environments' new states paid back on the last; then
the boundary-condition re-roll of the oldest environments on the
reference's cadence, the wave sources, and the epoch counter that drives
the learning-rate schedule; one row of `Loss_monitor.dat` per epoch;
rotating 3-slot checkpoints every 50 epochs and at the last, each with a
parameter histogram where TensorBoard is on. cfg.bucket_tiers is a
segment-engine option, which the block loop ignores, as in JAX.

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
from gen_fvgn_tpu_torch.training.train import TrainState
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
    if cfg.engine != "block":
        return (f"engine={cfg.engine!r}: the segment engine belongs to a "
                f"later slice of the port; use engine='block'")
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
    """Train cfg.net over the pool of `cases`, or of the cases read from
    `case_dirs` (`training/pool.py::load_case`), for `n_epochs` (default
    cfg.n_epochs) epochs; returns the final TrainState. The run directory
    (loss monitor, checkpoints, exports, TensorBoard events) is made under
    `log_base_dir` unless `logger` is given. `resume_from` names a
    checkpoint slot to start from. device="cuda" without a card raises;
    options of the JAX loop that the port does not carry yet raise
    NotImplementedError."""
    why = _unported(cfg)
    if why:
        raise NotImplementedError(why)
    dev = resolve_device(device)
    n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
    return _train_block(cfg, case_dirs, cases, log_base_dir, seed, n_epochs,
                        resume_from, logger, use_tensorboard, dev)


def _train_block(cfg, case_dirs, cases, log_base_dir, seed, n_epochs,
                 resume_from, logger, use_tensorboard, dev):
    """Block-engine loop against the shared per-case StaticPacks; the
    environments' states stay in the device pool. Batches hold one case
    each, or with cfg.mixed_case_batches are drawn across the cases and run
    as `MixedTrainStepBlock`. (The JAX loop draws a first batch to shape
    its parameters; the port's modules know their shapes from cfg, so none
    is drawn.)"""
    pool = EnvPool(case_dirs, cfg, seed=seed, cases=cases, engine="block",
                   tile=cfg.tile, device=dev)
    cfg = cfg.replace(dataset_size=len(pool))

    state, simulator = init_train_state_block(cfg, seed=seed, device=dev)
    if resume_from is not None:
        state = load_state(resume_from, like=state)
    step = make_train_step_block(cfg, simulator, device=dev)
    mixed = (MixedTrainStepBlock(cfg, simulator, device=dev)
             if cfg.mixed_case_batches else None)

    own_logger = logger is None
    if own_logger:
        logger = RunLogger(log_base_dir, cfg, seed=seed,
                           use_tensorboard=use_tensorboard)
    try:
        return _epochs(cfg, pool, state, step, mixed, logger, n_epochs)
    finally:
        if own_logger:
            logger.close()


def _epochs(cfg, pool, state, step, mixed, logger, n_epochs):
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
            payback = i_iter == cfg.max_inner_steps - 1
            if mixed is not None:
                for batch in pool.mixed_block_batches(step_seed=train_steps):
                    state, last_metrics = mixed.run_batch(
                        state, batch, pool.gather_block, pool.statics,
                        payback=pool.payback_block if payback else None)
                continue
            for ci, idxs in pool.block_batches(step_seed=train_steps):
                state, metrics, uvp_new = step(state, pool.gather_block(idxs),
                                               pool.statics[ci])
                last_metrics = metrics
                if payback:
                    pool.payback_block(idxs, uvp_new)

        export_dir = logger.results_dir if cfg.export_on_reset else None
        for _ in range(reset_pending):
            pool.reset_env_block(export_dir=export_dir)
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
