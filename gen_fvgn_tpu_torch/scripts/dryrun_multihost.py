"""Two-process dry run of the port's data parallelism, on the CPU.

    python -m gen_fvgn_tpu_torch.scripts.dryrun_multihost

Counterpart of `scripts/dryrun_multihost.py` (the JAX package's run of
its multi-host glue in two processes). Spawns 2 processes that join one
gloo process group (`parallel/launch.py`); each takes its 4 rows of a
global batch of 8 and runs one block-engine train step of TransFVGN_v2
(hidden 32, one message-passing block, float32, the 5x5 cavity) with the
gradient all-reduce; then the same step in this process at the global
batch. Prints one JSON line: the gaps (`tools/dp_check.py::compare`) and
"ok". Exits 0 when the ranks hold the same parameter bits and every gap
is within its limit. (The JAX script also saves and restores a sharded
orbax checkpoint; the port's checkpoints are one file written by rank 0,
so it has no such part.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

RANKS, STEPS = 2, 1


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)

    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.tools.dp_check import compare, run_steps

    batch = 4 * RANKS
    cfg = dict(batch_size=batch, dataset_size=batch, mxu_dtype="float32",
               hidden_size=32, message_passing_num=1, slice_num=8,
               attn_heads=4, engine="block", dp_devices=RANKS)
    case = synthetic_case(cavity_quad_mesh(5), continuity=1, convection=1,
                          grad_p=1, mu=0.05, sigma=(1, 1, 1))
    spec = dict(cfg=cfg, cases=[case], device="cpu", steps=STEPS, seed=0)
    t0 = time.perf_counter()
    ranks = spawn(run_steps, RANKS, dict(spec, dp=True), backend="gloo")
    dp_s = time.perf_counter() - t0
    single = run_steps(0, 1, dict(spec, dp=False))
    gaps = compare(single, ranks, lr=Config(**cfg).lr, steps=STEPS)
    print(json.dumps(dict(ranks=RANKS, global_batch=batch, steps=STEPS,
                          spawn_and_steps_s=dp_s,
                          losses=[m["loss"] for m in ranks[0]["metrics"]],
                          **gaps)))
    return 0 if gaps["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
