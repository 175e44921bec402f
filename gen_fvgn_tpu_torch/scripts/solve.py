"""Inference from a case directory: rollout, Adam or L-BFGS instance
optimisation.

    python -m gen_fvgn_tpu_torch.scripts.solve --case <case_dir> \
        --engine block --checkpoint <state> --mode {rollout,adam,lbfgs} \
        [--steps 100] [--inner-steps 20] [--device cuda]

Counterpart of the block branch of `scripts/solve.py` (`_solve_block`
:106-178), over the port's `rollout_block` (with the wave source of a
wave case), `solve_adam_block` and `solve_lbfgs_block`, from a checkpoint
that the port's training wrote (io/checkpoint.py). The flags and defaults
are the JAX script's, plus `--device` (default "cuda"; "cpu" must be asked
for). `--engine segment`, its default, raises NotImplementedError until
the segment engine is ported: pass `--engine block`. `--sp-devices` above
1 raises too. Each time step's solution is written to
`<out-dir>/step_<t>.dat`.
"""

from __future__ import annotations

import argparse
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

    if args.engine != "block":
        raise NotImplementedError(
            f"--engine {args.engine}: the segment engine belongs to a later "
            f"slice of the port; pass --engine block")
    if args.sp_devices > 1:
        raise NotImplementedError(
            "--sp-devices above 1: spatial parallelism belongs to a later "
            "slice of the port")

    from gen_fvgn_tpu_torch.config import Config
    cfg = Config(batch_size=1, dataset_size=1, order=args.order, net=args.net,
                 engine=args.engine)
    _solve_block(cfg, args)


def _solve_block(cfg, args):
    from gen_fvgn_tpu_torch.graph.physics import make_wave_source_fn
    from gen_fvgn_tpu_torch.io.checkpoint import load_state
    from gen_fvgn_tpu_torch.io.tecplot import write_tecplot_zone
    from gen_fvgn_tpu_torch.solve.instance_opt import (solve_adam_block,
                                                       solve_lbfgs_block)
    from gen_fvgn_tpu_torch.solve.rollout_block import rollout_block
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train_block import init_train_state_block

    pool = EnvPool([args.case], cfg, seed=0, engine="block", pad_multiple=128,
                   device=args.device)
    dyn = pool.gather_block(np.asarray([0]))
    static = pool.statics[0]
    state, sim = init_train_state_block(cfg, seed=0, device=args.device)
    if args.checkpoint:
        state = load_state(args.checkpoint, like=state)

    mesh = pool.cases[0]["mesh"]
    n_nodes = mesh["node|pos"].shape[0]

    def export(t, uvp_node, uvp_cell, rec):
        write_tecplot_zone(
            os.path.join(args.out_dir, f"step_{t:05d}.dat"),
            mesh["node|pos"], mesh["cells_node"], mesh["cells_index"],
            {"U": uvp_node[0, :n_nodes, 0], "V": uvp_node[0, :n_nodes, 1],
             "P": uvp_node[0, :n_nodes, 2]},
            face_node=mesh["face|face_node"],
            neighbour_cell=mesh["face|neighbour_cell"],
            solution_time=float(t))

    if args.mode == "rollout":
        src_fn = None
        ts = pool.envs[0].theta_sample
        if ts.source_frequency != 0:
            src_fn = make_wave_source_fn(mesh["node|pos"], ts,
                                         n_pad=dyn.uvp.shape[1],
                                         batch_size=1)
        hist = rollout_block(cfg, sim, state.norm_state, dyn, static,
                             n_steps=args.steps, export_fn=export,
                             wave_source_fn=src_fn)
        print(f"block rollout finished: final cont residual "
              f"{hist[-1]['loss_cont'][0]:.3e}")
    elif args.mode == "adam":
        _, hist = solve_adam_block(cfg, sim, state.norm_state, dyn, static,
                                   n_time_steps=args.steps,
                                   inner_steps=args.inner_steps,
                                   export_fn=export, device=args.device)
        print(f"block adam solve finished: last inner loss "
              f"{hist[-1]['inner_losses'][-1]:.5f}")
    else:
        _, hist = solve_lbfgs_block(cfg, sim, state.norm_state, dyn, static,
                                    n_time_steps=args.steps,
                                    max_iter=args.inner_steps,
                                    export_fn=export, device=args.device)
        print(f"block lbfgs solve finished: last inner loss "
              f"{hist[-1]['inner_losses'][-1]:.5f}")


if __name__ == "__main__":
    main()
