"""Rank functions of the data-parallel port tests (tests/test_torch_dp*.py),
run by `gen_fvgn_tpu_torch.parallel.launch.spawn` in fresh interpreters.
This module imports neither JAX nor the JAX package: a spawned rank
imports it by name."""

import dataclasses
import glob
import os

import numpy as np
import torch


def several(rank, world, specs):
    """`tools/dp_check.run_steps` for each spec in turn."""
    from gen_fvgn_tpu_torch.tools.dp_check import run_steps
    return [run_steps(rank, world, spec) for spec in specs]


def train_runs(rank, world, runs):
    """`train_rank` for each kwargs of `runs` in turn."""
    return [train_rank(rank, world, kwargs) for kwargs in runs]


def train_rank(rank, world, kwargs):
    """`training.loop.train(**kwargs)` on this rank, on the CPU; returns
    the parameters (flax paths), the pool's environments (boundary
    conditions, ages, age order, states) and the run directories under
    the log directory."""
    from gen_fvgn_tpu_torch.convert import flax_paths
    from gen_fvgn_tpu_torch.training import loop
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    pools = []
    orig = EnvPool.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        pools.append(self)
    EnvPool.__init__ = init
    try:
        state = loop.train(device="cpu", **kwargs)
    finally:
        EnvPool.__init__ = orig
    pool, = pools
    return dict(
        params=flax_paths({n: p.detach() for n, p in
                           state.simulator.named_parameters()}),
        step=state.step, epoch=state.epoch,
        thetas=[dataclasses.astuple(e.theta_sample) for e in pool.envs],
        ages=[e.age for e in pool.envs], age_order=list(pool._age_order),
        pools={ci: p.uvp.numpy() for ci, p in pool._dyn_pools.items()},
        run_dirs=sorted(glob.glob(os.path.join(kwargs["log_base_dir"], "*",
                                               "*"))))


def cli_rank(rank, world, argv, bad_argv):
    """The pre_train CLI with `argv` (which must run), then with
    `bad_argv` (whose error message is returned)."""
    from gen_fvgn_tpu_torch.scripts import pre_train
    pre_train.main(list(argv))
    try:
        pre_train.main(list(bad_argv))
    except RuntimeError as exc:
        return str(exc)
    return None


def collectives(rank, world, cfg_kwargs):
    """Each collective of `parallel/dp.py` on known values, and
    `broadcast_state` of a state whose weights (seed = rank) and Adam
    moments (one step on rank-dependent gradients) differ by rank."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.parallel import dp
    from gen_fvgn_tpu_torch.training.train import apply_update
    from gen_fvgn_tpu_torch.training.train_block import \
        init_train_state_block
    grads = [torch.full((2, 3), float(rank + 1)), torch.arange(4.0) * rank]
    local = torch.arange(6.0).reshape(3, 2) + 10 * rank
    state, sim = init_train_state_block(Config(**cfg_kwargs), seed=rank,
                                        device="cpu")
    params = list(sim.parameters())
    apply_update(state, params, [torch.full_like(p, rank + 1.0)
                                 for p in params], 1e-3)
    state.step, state.epoch = 5 + rank, 7 + rank
    state.norm_state.acc_count.fill_(3.0 + rank)
    dp.broadcast_state(state)
    adam = state.optimizer.state[params[0]]
    return dict(
        sum=dp.all_reduce_sum(torch.tensor([1.0, rank])),
        mean=dp.all_reduce_mean(torch.tensor([2.0 * rank])),
        grads=dp.all_reduce_grads(grads, 0.5),
        rows=dp.all_gather_rows(local, 3 * world),
        local=dp.local_rows(np.arange(4 * world), 4 * world),
        params=[p.detach().clone() for p in params],
        adam={k: v.clone() for k, v in adam.items()},
        counters=(state.step, state.epoch),
        acc_count=float(state.norm_state.acc_count))



def rows_and_payback(rank, world, spec):
    """A dp block step called alone, then one through
    `tools/dp_check.take_step` without the payback and one with it: the
    rows the first returns, the rows paid back, and whether each of the
    two left the pool as it was."""
    from gen_fvgn_tpu_torch.parallel import dp
    from gen_fvgn_tpu_torch.tools.dp_check import setup, take_step
    cfg, pool, state, _, step = setup(spec, dp=True)

    def pool_uvp():
        return {ci: p.uvp.clone() for ci, p in pool._dyn_pools.items()}

    def same(a, b):
        return all(torch.equal(a[c], b[c]) for c in a)
    ci, idxs = pool.block_batches(step_seed=0)[0]
    _, _, local = step(state, pool.gather_block(dp.local_rows(idxs, len(idxs))),
                       pool.statics[ci])
    before = pool_uvp()
    _, _, _, skipped = take_step(cfg, pool, state, step, 1, True, world,
                                 False, payback=False)
    unpaid = pool_uvp()
    _, _, idxs2, paid = take_step(cfg, pool, state, step, 2, True, world,
                                  False)
    return dict(local_rows=local.shape[0], skipped=skipped,
                unchanged=same(before, unpaid), paid_rows=paid.shape[0],
                batch=len(idxs2), paid_back=not same(unpaid, pool_uvp()))
