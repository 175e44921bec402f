"""Spatially parallel runs of the block train steps, for holding them
against the single-process steps: the worker functions that
`parallel.launch.spawn` runs on each rank, and the comparison.

* `run_steps(rank, world, spec)`: `spec["steps"]` train steps of the
  block engine (`make_train_step_block`, or `MixedTrainStepBlock` with
  `spec["mixed"]`), each on the pool's first batch of the step's draw,
  paid back after every step. With `spec["ranks"]` the run is the
  (dp_devices, sp_devices) grid of the Config over the process group
  (`parallel.sp.groups`): the rank takes its batch rows and node rows
  against its cut of the statics; without it this is the single-process
  run at the global batch on the same padded pool. Returns what
  `tools/dp_check.run_steps` returns, and the gradients of step 1
  (Adam's first moment after its first step, (1 − β1)·g, as `mu1`), the
  bytes and calls of `all_reduce` a step, and the kernel launches.
* `compare(single, ranks, lr, steps, dtype)`: `tools/dp_check.compare`
  at the JAX sp tests' limits for the stream type (`LIMITS`), and the
  gradients of step 1 against the single process's: the largest gap over
  the largest gradient element of the step (`grad_gaps`), limit 1e-3 in
  float32 and 5e-2 in bfloat16 (a stray factor of sp_devices is a gap of
  0.5 or more; grad_norm, held to 1e-3, sees it too).
* `solve_rank(rank, world, argv)`: the `solve` CLI on a rank, with the
  history it returns and its launches.

`spec` holds picklable values only: "cfg" (Config fields), "cases" (case
dicts of NumPy arrays, `meshes/synthetic.py`), "device", "steps", "seed",
"start" (a checkpoint slot to start from, or None), "ranks", "mixed",
"plain" (the kernels' plain versions on a card).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def count_all_reduce():
    """Counts every `torch.distributed.all_reduce` inside: yields a dict
    whose "bytes" and "calls" grow with each call (the modules call it
    through the `torch.distributed` namespace)."""
    seen = {"bytes": 0, "calls": 0}
    orig = dist.all_reduce

    def counted(t, *a, **k):
        seen["bytes"] += t.numel() * t.element_size()
        seen["calls"] += 1
        return orig(t, *a, **k)
    dist.all_reduce = counted
    try:
        yield seen
    finally:
        dist.all_reduce = orig


def setup(spec):
    """(cfg, pool, state, simulator, step, layout, statics) of `spec`: the
    pool of its cases padded to tile·sp_devices, the state from seed
    spec["seed"] (or the checkpoint spec["start"]), rank 0's on every
    rank, and the step; with spec["ranks"] the rank's layout and cuts of
    the statics, else the single-process step on the whole statics."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.io.checkpoint import load_state
    from gen_fvgn_tpu_torch.parallel import dp as dp_mod
    from gen_fvgn_tpu_torch.parallel import sp as sp_mod
    from gen_fvgn_tpu_torch.tools.dp_check import _device
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train_block import (
        MixedTrainStepBlock, init_train_state_block, make_train_step_block)
    dev = _device(spec)
    cfg = Config(**spec["cfg"])
    ranks = bool(spec.get("ranks"))
    lay = (sp_mod.groups(max(cfg.dp_devices, 1), cfg.sp_devices)
           if ranks else None)
    pool = EnvPool([], cfg, seed=0, cases=[dict(c) for c in spec["cases"]],
                   engine="block", tile=cfg.tile, device=dev)
    cfg = cfg.replace(dataset_size=len(pool))
    state, sim = init_train_state_block(cfg, seed=spec.get("seed", 0),
                                        device=dev)
    if spec.get("start"):
        load_state(spec["start"], like=state)
    statics = pool.statics
    if ranks:
        dp_mod.broadcast_state(state)
        statics = [sp_mod.shard_static_sp(s, lay.sp, lay.sp_index)
                   for s in statics]
    dp = ranks and cfg.dp_devices > 1
    if spec.get("mixed"):
        step = MixedTrainStepBlock(cfg, sim, device=dev, dp=dp, sp=ranks)
    else:
        step = make_train_step_block(cfg, sim, device=dev, dp=dp, sp=ranks)
    return cfg, pool, state, sim, step, lay, statics


def take_step(cfg, pool, state, step, k: int, lay, statics, mixed: bool,
              payback: bool = True):
    """Train step k on the first batch of the pool's draw for step seed k
    (the rank's rows of it under `lay`), paid back where `payback`;
    returns (state, metrics, the batch's environment indices, the global
    states paid back or None; of a mixed batch its groups' real rows,
    flattened)."""
    from gen_fvgn_tpu_torch.parallel import dp as dp_mod
    from gen_fvgn_tpu_torch.parallel import sp as sp_mod
    n_dev = max(cfg.dp_devices, 1)
    if mixed:
        paid = []
        batch = pool.mixed_block_batches(step_seed=k, n_dev=n_dev)[0]
        state, m = step.run_batch(
            state, batch, pool.gather_block, statics,
            payback=(lambda ix, u: (pool.payback_block(ix, u),
                                    paid.append(u))) if payback else None)
        idxs = np.concatenate([ix[:g] for _, ix, _, g in batch])
        return state, m, idxs, (torch.cat([u.reshape(-1) for u in paid])
                                if payback else None)
    ci, idxs = pool.block_batches(step_seed=k)[0]
    mine = idxs
    if lay is not None and n_dev > 1:
        mine = dp_mod.local_rows(idxs, len(idxs), process_id=lay.dp_index,
                                 process_count=lay.dp)
    dyn = pool.gather_block(mine)
    if lay is not None:
        dyn = sp_mod.local_rows_sp(dyn, lay)
    state, m, uvp = step(state, dyn, statics[ci])
    if not payback:
        return state, m, idxs, None
    if lay is not None:
        uvp = sp_mod.gather_states(uvp, len(idxs), lay)
    pool.payback_block(idxs, uvp)
    return state, m, idxs, uvp


def _first_moments(state, sim) -> dict:
    from gen_fvgn_tpu_torch.convert import flax_paths
    return flax_paths({n: state.optimizer.state[p]["exp_avg"].detach().cpu()
                       for n, p in sim.named_parameters()
                       if p in state.optimizer.state})


def run_steps(rank: int, world: int, spec) -> dict:
    """`spec["steps"]` steps (the module's docstring)."""
    from gen_fvgn_tpu_torch.ops import (launch_counts, plain_versions,
                                        zero_launch_counts)
    from gen_fvgn_tpu_torch.tools.dp_check import _numpy_state, _sync
    mixed = bool(spec.get("mixed"))
    cfg, pool, state, sim, step, lay, statics = setup(spec)
    dev = next(sim.parameters()).device
    metrics, idxs_all, ms, uvp_first, mu1, reduced = [], [], [], None, None, []
    zero_launch_counts()
    with (plain_versions() if spec.get("plain")
          else contextlib.nullcontext()):
        for k in range(spec["steps"]):
            _sync(dev)
            t0 = time.perf_counter()
            with count_all_reduce() as seen:
                state, m, idxs, uvp = take_step(cfg, pool, state, step, k,
                                                lay, statics, mixed)
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            reduced.append(dict(seen))
            if uvp_first is None:
                uvp_first = uvp.cpu().numpy()
                mu1 = _first_moments(state, sim)
            metrics.append({f: float(getattr(m, f)) for f in (
                "loss", "loss_cont", "loss_mom", "loss_press", "grad_norm")})
            idxs_all.append(np.asarray(idxs))
    launches = launch_counts()
    params, norm = _numpy_state(state, sim)
    return dict(rank=rank, world=world, params=params, norm=norm,
                metrics=metrics, idxs=idxs_all, uvp_first=uvp_first,
                mu1=mu1, reduced=reduced,
                pools={ci: p.uvp.cpu().numpy()
                       for ci, p in pool._dyn_pools.items()},
                ages=[e.age for e in pool.envs], launches=launches,
                step_ms=ms, step=state.step)


def grad_gaps(got: dict, ref: dict) -> float:
    """The largest gap between two runs' step-1 gradients (first moments)
    over the largest element of the reference's, both over every
    parameter (a parameter whose gradients are float noise around zero,
    as the slice projections' biases, is judged on the step's scale)."""
    gap = max(float(np.abs(np.asarray(got[k], np.float64) - ref[k]).max())
              for k in ref)
    return gap / max(max(float(np.abs(ref[k]).max()) for k in ref), 1e-30)


# the limits of the JAX package's sp tests: float32 those of
# tests/test_parallel.py::test_block_engine_dp_sp_matches_single_device,
# bfloat16 those of tests/test_sp_fused.py::
# test_block_step_sp_fused_matches_unsharded; "grads" is the step-1
# gradients' (a bfloat16 stream rounds each rank's weight-gradient partial
# sums to bfloat16 before the ranks' sum, a few bfloat16 ulps)
LIMITS = {"float32": dict(loss=1e-5, rtol=1e-4, atol=1e-5, grads=1e-3),
          "bfloat16": dict(loss=1e-4, rtol=1e-3, atol=1e-3, grads=5e-2)}


def compare(single: dict, ranks, lr: float, steps: int,
            dtype: str = "float32") -> dict:
    """`tools/dp_check.compare` at the limits of the stream type `dtype`
    (`LIMITS`: step 1's loss and new states), with the step-1 gradients;
    grad_norm rtol 1e-3, parameters rtol 1e-3 + atol 2.2·lr a step, the
    normalizer 1e-5, as there."""
    from gen_fvgn_tpu_torch.tools.dp_check import compare as dp_compare
    lim = LIMITS[dtype]
    out = dp_compare(single, ranks, lr, steps)
    ref = single["uvp_first"]
    out["loss_limit"] = lim["loss"]
    out["uvp_max_abs"] = float(np.abs(ranks[0]["uvp_first"] - ref).max())
    out["uvp_excess"] = float((np.abs(ranks[0]["uvp_first"] - ref)
                               - (lim["rtol"] * np.abs(ref)
                                  + lim["atol"])).max())
    out["grads_rel"] = grad_gaps(ranks[0]["mu1"], single["mu1"])
    out["grads_limit"] = lim["grads"]
    out["ok"] = bool(
        out["ranks_same_bits"] and out["ranks_same_pool"]
        and out["same_batches"] and out["loss_rel"] <= lim["loss"]
        and out["grad_norm_rel"] <= 1e-3 and out["uvp_excess"] <= 0
        and out["params_excess"] <= 0 and out["norm_rel"] <= 1e-5
        and out["grads_rel"] <= lim["grads"])
    return out


def solve_rank(rank: int, world: int, argv) -> dict:
    """`scripts.solve.main(argv)` on this rank, with its launches and the
    history it returns (the whole mesh's states on every rank)."""
    from gen_fvgn_tpu_torch.ops import launch_counts, zero_launch_counts
    from gen_fvgn_tpu_torch.scripts import solve
    zero_launch_counts()
    t0 = time.perf_counter()
    hist = solve.main(list(argv))
    return dict(seconds=time.perf_counter() - t0, launches=launch_counts(),
                hist=[{k: np.asarray(v) for k, v in rec.items()}
                      for rec in hist])
