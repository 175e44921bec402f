"""Data-parallel runs of the train steps, for holding them against the
single-process steps: the worker functions that `parallel.launch.spawn`
runs on each rank, and the comparison.

* `run_steps(rank, world, spec)`: `spec["steps"]` train steps of the
  block engine (`make_train_step_block`), of its mixed-case step
  (`MixedTrainStepBlock`, `spec["mixed"]`) or of the segment engine
  (`make_train_step`), each on the pool's first batch of the step's draw,
  paid back after every step. With `spec["dp"]` the rank takes its rows
  and the steps reduce over the process group; without it this is the
  single-process run at the global batch. Returns the parameters, the
  metrics, the normalizer, the first step's new states, the pool's states
  and the kernel launches, as NumPy.
* `compare(single, ranks, lr, steps)`: the gaps between the ranks and the
  single-process run, against the limits of the JAX package's own dp test
  (`tests/test_parallel.py`: loss rtol 1e-5, grad_norm rtol 1e-3, states
  rtol 1e-4 + atol 1e-5 after one step, parameters rtol 1e-3 + atol
  2.2·lr, here for each step taken), and whether the ranks' parameters
  are the same bits.
* `wrapper_cost(rank, world, spec)`: the same steps with and without the
  dp wrapper on a group of one rank (the collectives of one rank are the
  identity), their bits, ms a step and, on a card, device-busy ms a step
  and kernels a step (torch.profiler).
* `pre_train_rank(rank, world, argv)`: the `pre_train` CLI on a rank.

`spec` holds picklable values only: "cfg" (Config fields), "cases" (case
dicts of NumPy arrays, `meshes/synthetic.py`), "device", "steps", "seed",
"start" (a checkpoint slot to start from, or None), "pad_multiple", "dp",
"mixed".
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _device(spec):
    from gen_fvgn_tpu_torch.utils.device import resolve_device
    dev = resolve_device(spec.get("device", "cuda"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return dev


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(spec, dp: bool):
    """(cfg, pool, state, simulator, step) of `spec`: the pool of its
    cases, the state from seed spec["seed"] (or the checkpoint
    spec["start"]) and the step of its engine, with `dp` or without."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.io.checkpoint import load_state
    from gen_fvgn_tpu_torch.parallel import dp as dp_mod
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train import (init_train_state,
                                                   make_train_step)
    from gen_fvgn_tpu_torch.training.train_block import (
        MixedTrainStepBlock, init_train_state_block, make_train_step_block)
    dev = _device(spec)
    cfg = Config(**spec["cfg"])
    block = cfg.engine == "block"
    pool = EnvPool([], cfg, seed=0, cases=[dict(c) for c in spec["cases"]],
                   engine=cfg.engine, pad_multiple=spec.get("pad_multiple",
                                                            128),
                   device=dev)
    cfg = cfg.replace(dataset_size=len(pool))
    init = init_train_state_block if block else init_train_state
    state, sim = init(cfg, seed=spec.get("seed", 0), device=dev)
    if spec.get("start"):
        load_state(spec["start"], like=state)
    if dp:
        dp_mod.broadcast_state(state)
    if spec.get("mixed"):
        step = MixedTrainStepBlock(cfg, sim, device=dev, dp=dp)
    elif block:
        step = make_train_step_block(cfg, sim, device=dev, dp=dp)
    else:
        step = make_train_step(cfg, sim, device=dev, dp=dp)
    return cfg, pool, state, sim, step


def take_step(cfg, pool, state, step, k: int, dp: bool, world: int,
              mixed: bool, payback: bool = True):
    """Train step k on the first batch of the pool's draw for step seed k,
    paid back where `payback` (as the training loop does on an epoch's
    last inner step); returns (state, metrics, the batch's environment
    indices, the states paid back, or None; of a mixed batch its groups'
    real rows, flattened). A dp step's states are gathered from every
    rank only for the payback."""
    from gen_fvgn_tpu_torch.parallel import dp as dp_mod
    paid = []
    if mixed:
        batch = pool.mixed_block_batches(step_seed=k, n_dev=world)[0]
        state, m = step.run_batch(
            state, batch, pool.gather_block, pool.statics,
            payback=(lambda ix, u: (pool.payback_block(ix, u),
                                    paid.append(u))) if payback else None)
        idxs = np.concatenate([ix[:g] for _, ix, _, g in batch])
        return state, m, idxs, (torch.cat([u.reshape(-1) for u in paid])
                                if payback else None)
    block = cfg.engine == "block"
    if block:
        ci, idxs = pool.block_batches(step_seed=k)[0]
    else:
        idxs = pool.batch_indices(step_seed=k)[0]
    mine = dp_mod.local_rows(idxs, len(idxs)) if dp else idxs
    if block:
        state, m, uvp = step(state, pool.gather_block(mine), pool.statics[ci])
    else:
        state, m, uvp = step(state, pool.gather_batch(mine))
    if not payback:
        return state, m, idxs, None
    if dp:
        uvp = dp_mod.all_gather_rows(uvp, len(idxs))
    (pool.payback_block if block else pool.payback)(idxs, uvp)
    return state, m, idxs, uvp


def _numpy_state(state, sim):
    from gen_fvgn_tpu_torch.convert import flax_paths
    named = {n: p.detach().cpu() for n, p in sim.named_parameters()}
    norm = {f: getattr(state.norm_state, f).detach().cpu().numpy()
            for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_acc")}
    return flax_paths(named), norm


def run_steps(rank: int, world: int, spec) -> dict:
    """`spec["steps"]` steps (the module's docstring); every collective of
    a dp run is on the default group."""
    from gen_fvgn_tpu_torch.ops import launch_counts, zero_launch_counts
    dp = bool(spec.get("dp"))
    mixed = bool(spec.get("mixed"))
    cfg, pool, state, sim, step = setup(spec, dp)
    dev = next(sim.parameters()).device
    metrics, idxs_all, ms, uvp_first = [], [], [], None
    zero_launch_counts()
    for k in range(spec["steps"]):
        _sync(dev)
        t0 = time.perf_counter()
        state, m, idxs, uvp = take_step(cfg, pool, state, step, k, dp,
                                        world if dp else 1, mixed)
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        if uvp_first is None:
            uvp_first = uvp.cpu().numpy()
        metrics.append({f: float(getattr(m, f)) for f in (
            "loss", "loss_cont", "loss_mom", "loss_press", "grad_norm")})
        idxs_all.append(np.asarray(idxs))
    launches = launch_counts()
    params, norm = _numpy_state(state, sim)
    pools = {ci: p.uvp.cpu().numpy() for ci, p in
             (pool._dyn_pools.items() if cfg.engine == "block"
              else pool._tier_data.items())}
    return dict(rank=rank, world=world, params=params, norm=norm,
                metrics=metrics, idxs=idxs_all, uvp_first=uvp_first,
                pools=pools, ages=[e.age for e in pool.envs],
                launches=launches, step_ms=ms, step=state.step)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def compare(single: dict, ranks, lr: float, steps: int) -> dict:
    """The gaps of the dp ranks against the single-process run and the
    limits they are held to: step 1's loss, gradient norm and new states
    (later steps start from parameters that Adam's sign steps have moved
    apart), the normalizer and the parameters after the last step (2.2·lr
    for each step taken); "ok" where every gap is within its limit and the
    ranks hold the same parameter bits and pools."""
    r0 = ranks[0]
    same_bits = all(
        all(np.array_equal(r["params"][k], r0["params"][k])
            for k in r0["params"]) for r in ranks[1:])
    same_pool = all(
        all(np.array_equal(r["pools"][c], r0["pools"][c]) for c in r0["pools"])
        for r in ranks[1:])
    first, ref = r0["metrics"][0], single["metrics"][0]
    loss = abs(first["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30)
    gnorm = abs(first["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    uvp_excess = float((np.abs(r0["uvp_first"] - single["uvp_first"])
                        - (1e-4 * np.abs(single["uvp_first"]) + 1e-5)).max())
    p_atol = 2.2 * lr * steps
    p_excess = max(float((np.abs(r0["params"][k] - single["params"][k])
                          - (1e-3 * np.abs(single["params"][k])
                             + p_atol)).max())
                   for k in single["params"])
    p_max = max(float(np.abs(r0["params"][k] - single["params"][k]).max())
                for k in single["params"])
    norm = max(_rel(r0["norm"][k], single["norm"][k]) for k in single["norm"])
    later = [abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-30)
             for a, b in zip(r0["metrics"][1:], single["metrics"][1:])]
    out = dict(ranks_same_bits=same_bits, ranks_same_pool=same_pool,
               same_batches=all(np.array_equal(a, b) for a, b in
                                zip(r0["idxs"], single["idxs"])),
               loss_rel=loss, loss_limit=1e-5, grad_norm_rel=gnorm,
               grad_norm_limit=1e-3, uvp_excess=uvp_excess,
               params_max_abs=p_max, params_atol=p_atol,
               params_excess=p_excess, norm_rel=norm, norm_limit=1e-5,
               later_loss_rel=later)
    out["ok"] = bool(same_bits and same_pool and out["same_batches"]
                     and loss <= 1e-5 and gnorm <= 1e-3 and uvp_excess <= 0
                     and p_excess <= 0 and norm <= 1e-5)
    return out


def wrapper_cost(rank: int, world: int, spec) -> dict:
    """On a group of one rank: spec["steps"] steps from the same start
    without and with the dp wrapper, paid back, the parameters' bits
    compared after them, then spec["timed"] more steps of each,
    alternating, on the host clock ending in a synchronize, then on a card
    5 steps of each under torch.profiler ((device-busy ms, kernels) a step;
    None where the profiler reports no device time). The timed steps are
    not paid back: the training loop pays back one inner step in
    cfg.max_inner_steps, so the wrapper's cost a step is that of its
    reductions, without the states' gather."""
    if world != 1:
        raise ValueError("wrapper_cost runs on a group of one rank")
    runs = {}
    for dp in (False, True):
        cfg, pool, state, sim, step = setup(spec, dp)
        for k in range(spec["steps"]):
            state, *_ = take_step(cfg, pool, state, step, k, dp, 1, False)
        runs[dp] = (cfg, pool, state, sim, step)
    same = all(torch.equal(a, b) for a, b in zip(
        runs[False][3].parameters(), runs[True][3].parameters()))
    dev = next(runs[False][3].parameters()).device
    ms = {False: [], True: []}
    for i in range(spec["timed"]):
        for dp in ((False, True) if i % 2 == 0 else (True, False)):
            cfg, pool, state, sim, step = runs[dp]
            _sync(dev)
            t0 = time.perf_counter()
            take_step(cfg, pool, state, step, spec["steps"] + i, dp, 1, False,
                      payback=False)
            _sync(dev)
            ms[dp].append(1e3 * (time.perf_counter() - t0))
    busy = {}
    if dev.type == "cuda":
        from gen_fvgn_tpu_torch.tools.profile_rollout import device_profile
        for dp in (False, True):
            cfg, pool, state, sim, step = runs[dp]

            def window(n):
                for k in range(n):
                    take_step(cfg, pool, state, step, k, dp, 1, False,
                              payback=False)
            _, rows = device_profile(window, 5)
            busy[dp] = (sum(r[0] for r in rows) if rows else None,
                        sum(r[1] for r in rows))
    return dict(same_bits=same, ms_plain=ms[False], ms_dp=ms[True],
                busy_plain=busy.get(False), busy_dp=busy.get(True))


def pre_train_rank(rank: int, world: int, argv) -> dict:
    """`scripts.pre_train.main(argv)` on this rank, with its launches."""
    from gen_fvgn_tpu_torch.ops import launch_counts, zero_launch_counts
    from gen_fvgn_tpu_torch.scripts import pre_train
    zero_launch_counts()
    t0 = time.perf_counter()
    pre_train.main(list(argv))
    return dict(seconds=time.perf_counter() - t0, launches=launch_counts())
