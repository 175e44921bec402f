"""Inference from a case directory: rollout, Adam or L-BFGS instance
optimisation.

    python -m gen_fvgn_tpu_torch.scripts.solve --case <case_dir> \
        --checkpoint <state> --mode {rollout,adam,lbfgs} \
        [--engine segment|block] [--steps 100] [--inner-steps 20] \
        [--device cuda]

Counterpart of `scripts/solve.py`: on the segment engine (`--engine
segment`, the default, as in JAX) over the port's `rollout`, `solve_adam`
and `solve_lbfgs`; on the block engine (`_solve_block`) over
`rollout_block`, `solve_adam_block` and `solve_lbfgs_block`; the wave
source added in a rollout of a wave case. The checkpoint is one the port's
training wrote (io/checkpoint.py), by either engine: the nets of both share
one parameter tree. The flags and defaults are the JAX script's, plus
`--device` (default "cuda"; "cpu" must be asked for). Each time step's
solution is written to `<out-dir>/step_<t>.dat`.

`--sp-devices S` above 1 (the block engine only; without `--engine block`
the script exits, as the JAX script does) solves one mesh cut over S
ranks, one process a rank (`parallel/sp.py`):

    torchrun --nproc_per_node S -m gen_fvgn_tpu_torch.scripts.solve \
        --case <case_dir> --engine block --sp-devices S ...

The world size must be S (else a RuntimeError before the case is read);
the pool pads every entity to tile × S rows, each rank runs its rows, and
rank 0 writes the whole mesh's solution.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", required=True, help="case dir with BC.json")
    ap.add_argument("--checkpoint", default=None, help=".state file")
    ap.add_argument("--mode", default="rollout",
                    choices=["rollout", "adam", "lbfgs"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--inner-steps", type=int, default=20)
    ap.add_argument("--out-dir", default="solve_out")
    ap.add_argument("--order", default="2nd")
    ap.add_argument("--net", default="TransFVGN_v2")
    ap.add_argument("--engine", default="segment",
                    choices=["segment", "block"])
    ap.add_argument("--sp-devices", type=int, default=1,
                    help="spatial shards for the block engine")
    ap.add_argument("--device", default="cuda",
                    help="torch device (\"cpu\" only when asked)")
    args = ap.parse_args(argv)

    if args.sp_devices > 1 and args.engine != "block":
        raise SystemExit("--sp-devices requires --engine block")

    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.parallel.launch import rank_group
    cfg = Config(batch_size=1, dataset_size=1, order=args.order, net=args.net,
                 engine=args.engine, sp_devices=args.sp_devices)
    if args.engine != "block":
        return _solve_segment(cfg, args)
    group = (rank_group(1, args.sp_devices, args.device)
             if args.sp_devices > 1 else contextlib.nullcontext(args.device))
    with group as device:
        args.device = device
        return _solve_block(cfg, args)


def _pool(cfg, args):
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    return EnvPool([args.case], cfg, seed=0, engine=args.engine,
                   pad_multiple=128, device=args.device)


def _solve_segment(cfg, args):
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_adam, solve_lbfgs
    from gen_fvgn_tpu_torch.solve.rollout import rollout
    from gen_fvgn_tpu_torch.training.train import init_train_state
    pool = _pool(cfg, args)
    batch = pool.gather_batch(np.asarray([0]))
    state, sim = init_train_state(cfg, seed=0, device=args.device)
    return _run(args, pool, state, batch, "", lambda export, src_fn: dict(
        rollout=lambda: rollout(cfg, sim, state.norm_state, batch,
                                n_steps=args.steps, export_fn=export,
                                wave_source_fn=src_fn),
        adam=lambda: solve_adam(cfg, sim, state.norm_state, batch,
                                n_time_steps=args.steps,
                                inner_steps=args.inner_steps,
                                export_fn=export, device=args.device)[1],
        lbfgs=lambda: solve_lbfgs(cfg, sim, state.norm_state, batch,
                                  n_time_steps=args.steps,
                                  max_iter=args.inner_steps,
                                  export_fn=export, device=args.device)[1]))


def _solve_block(cfg, args):
    """The block engine's solve; with cfg.sp_devices > 1 on the rank's rows
    (in the joined process group), every rank holding the same weights."""
    from gen_fvgn_tpu_torch.parallel import sp as sp_mod
    from gen_fvgn_tpu_torch.solve.instance_opt import (solve_adam_block,
                                                       solve_lbfgs_block)
    from gen_fvgn_tpu_torch.solve.rollout_block import rollout_block
    from gen_fvgn_tpu_torch.training.train_block import init_train_state_block
    pool = _pool(cfg, args)
    dyn = pool.gather_block(np.asarray([0]))
    static = pool.statics[0]
    state, sim = init_train_state_block(cfg, seed=0, device=args.device)
    sp = cfg.sp_devices > 1
    if sp:
        lay = sp_mod.groups(1, cfg.sp_devices)
        static = sp_mod.shard_static_sp(static, lay.sp, lay.sp_index)
        dyn = sp_mod.local_rows_sp(dyn, lay)
    return _run(args, pool, state, dyn, "block ", lambda export, src_fn: dict(
        rollout=lambda: rollout_block(cfg, sim, state.norm_state, dyn,
                                      static, n_steps=args.steps,
                                      export_fn=export, sp=sp,
                                      wave_source_fn=src_fn),
        adam=lambda: solve_adam_block(cfg, sim, state.norm_state, dyn,
                                      static, n_time_steps=args.steps,
                                      inner_steps=args.inner_steps,
                                      export_fn=export, sp=sp,
                                      device=args.device)[1],
        lbfgs=lambda: solve_lbfgs_block(cfg, sim, state.norm_state, dyn,
                                        static, n_time_steps=args.steps,
                                        max_iter=args.inner_steps,
                                        export_fn=export, sp=sp,
                                        device=args.device)[1]),
        n_pad=pool.statics[0].pos.shape[0])


def _run(args, pool, state, data, label, modes, n_pad=None):
    """Load the checkpoint into `state` (in place; every rank loads the
    same weights), then run args.mode of modes(export, wave source) on `data`, exporting every
    time step (on rank 0 alone under a process group); returns the run's
    history. `n_pad`: the whole mesh's padded node count (default
    `data`'s)."""
    from gen_fvgn_tpu_torch.parallel.multihost import world
    from gen_fvgn_tpu_torch.graph.physics import make_wave_source_fn
    from gen_fvgn_tpu_torch.io.checkpoint import load_state
    from gen_fvgn_tpu_torch.io.tecplot import write_tecplot_zone
    if args.checkpoint:
        load_state(args.checkpoint, like=state)
    mesh = pool.cases[0]["mesh"]
    n_nodes = mesh["node|pos"].shape[0]
    rank0 = world()[0] == 0

    def export(t, uvp_node, uvp_cell, rec):
        if not rank0:
            return
        write_tecplot_zone(
            os.path.join(args.out_dir, f"step_{t:05d}.dat"),
            mesh["node|pos"], mesh["cells_node"], mesh["cells_index"],
            {"U": uvp_node[0, :n_nodes, 0], "V": uvp_node[0, :n_nodes, 1],
             "P": uvp_node[0, :n_nodes, 2]},
            face_node=mesh["face|face_node"],
            neighbour_cell=mesh["face|neighbour_cell"],
            solution_time=float(t))

    src_fn = None
    ts = pool.envs[0].theta_sample
    if args.mode == "rollout" and ts.source_frequency != 0:
        src_fn = make_wave_source_fn(
            mesh["node|pos"], ts, n_pad=n_pad or data.uvp.shape[1],
            batch_size=1)
    hist = modes(export, src_fn)[args.mode]()
    if args.mode == "rollout":
        print(f"{label}rollout finished: final cont residual "
              f"{hist[-1]['loss_cont'][0]:.3e}")
    else:
        print(f"{label}{args.mode} solve finished: last inner loss "
              f"{hist[-1]['inner_losses'][-1]:.5f}")
    return hist


if __name__ == "__main__":
    main()
