"""The readings the limits of `correct` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control 1] [--faults state_unchanged,...]

For each seed: the cell's set-up and a window of `--seconds` (a rollout
cell needs long enough to finish a request or more), then the numbers that
`run.py` compares: the program's against the reference (the lower
readings), with `--control 1` the reference in float8 in the program's
place against the reference (the control's, the upper readings), and for
each fault of `--faults` the program with that fault planted in it. One
JSON line a seed and reading. The benchmark's own runs never run this.

Faults (`FAULTS`), planted in the program's modules:

* state_unchanged: a train step that leaves the parameters as they were
  (Adam's update skipped); a rollout step that returns its input state;
* half_batch: a train step that sees half of its batch, the loss the mean
  over those rows; a rollout step whose second half of the batch is a copy
  of the first;
* answer_altered: the step's answer altered where it is produced: a train
  step's residuals doubled; a rollout step's first sample's u negated.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _half(batch):
    b = batch.uvp.shape[0] // 2
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[:b]
        for f in dataclasses.fields(batch)})


def _alter_rollout(out, how, uvp_in):
    import torch
    node, cell = out.uvp_node_new, out.uvp_cell_new
    if how == "state_unchanged":
        node = uvp_in.to(node.dtype).clone()
    elif how == "half_batch":
        b = node.shape[0] // 2
        node = torch.cat([node[:b], node[:node.shape[0] - b]])
        cell = torch.cat([cell[:b], cell[:cell.shape[0] - b]])
    elif how == "answer_altered":
        node = node.clone()
        node[0, :, 0] = -node[0, :, 0]
    return out._replace(uvp_node_new=node, uvp_cell_new=cell)


@contextlib.contextmanager
def fault(how: str, mode: str, engine: str):
    """Plant fault `how` in the program for the duration."""
    from gen_fvgn_tpu_torch.training import forward as fwd
    from gen_fvgn_tpu_torch.training import forward_block as fwdb
    from gen_fvgn_tpu_torch.training import train as tmod
    from gen_fvgn_tpu_torch.training import train_block as bmod
    from gen_fvgn_tpu_torch.solve import rollout as ro
    from gen_fvgn_tpu_torch.solve import rollout_block as rb
    saved = []

    def patch(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    if mode == "train" and how == "state_unchanged":
        patch(tmod, "apply_update", lambda *a, **k: None)
        patch(bmod, "apply_update", lambda *a, **k: None)
    elif mode == "train" and how == "half_batch":
        for mod, name in ((tmod, "make_train_step"),
                          (bmod, "make_train_step_block")):
            orig = getattr(mod, name)

            def make(*a, _orig=orig, **k):
                step = _orig(*a, **k)
                return lambda state, batch, *rest: step(state, _half(batch),
                                                        *rest)
            patch(mod, name, make)
    elif mode == "train" and how == "answer_altered":
        for mod, name in ((fwd, "integrate_residuals"),
                          (fwdb, "integrate_residuals_block_packed")):
            orig = getattr(mod, name)

            def doubled(*a, _orig=orig, **k):
                losses, rt, cell = _orig(*a, **k)
                return (type(losses)(*[2.0 * v for v in losses]), rt, cell)
            patch(mod, name, doubled)
    elif mode == "rollout":
        name = "forward_batch_block" if engine == "block" else "forward_batch"
        mod = rb if engine == "block" else ro
        orig = getattr(mod, name)

        def altered(simulator, norm_state, batch, *a, **k):
            out = orig(simulator, norm_state, batch, *a, **k)
            return _alter_rollout(out, how, batch.uvp)
        patch(mod, name, altered)
    else:
        raise ValueError(f"no fault {how!r} for a {mode} cell")
    try:
        yield
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def readings(workload: str, seed: int, seconds: float, device="cuda",
             control: bool = False, how: str = None, cell=None):
    """(program numbers, control numbers or None, limits) of one seed."""
    from benchmark.harness import cells, check, spec
    cell = cell or spec.load_cell(workload)
    mode = cell.traffic["mode"]
    drv = (cells.Train if mode == "train" else cells.Rollout)(
        cell, seed, device)
    ctx = fault(how, mode, drv.engine) if how else contextlib.nullcontext()
    try:
        with ctx:
            drv.setup()
            if mode == "rollout":
                drv.window(seconds)
        drv.free()
        _, numbers, ctrl, details = check.compare(drv, cell, seed, control)
        for line in details:
            print(f"detail seed {seed}: {line}", file=sys.stderr)
        return numbers, ctrl, cell.limits
    finally:
        drv.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        numbers, ctrl, limits = readings(args.workload, seed, args.seconds,
                                         control=bool(args.control))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": numbers, "control": ctrl,
                          "limits": limits}), flush=True)
    for how in [f for f in args.faults.split(",") if f]:
        for seed in seeds[:3]:
            numbers, _, limits = readings(args.workload, seed, args.seconds,
                                          how=how)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": how, "program": numbers,
                              "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
