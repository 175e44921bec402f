"""Runs one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's system from the seed (case on disk, environment pool,
weights on the card), warms up every shape the window uses, measures for
`--seconds` seconds, and checks what the timed path produced against the
plain reference. `--trace 0` reports the cell's end-to-end metrics and
turns none of the program's spans on. `--trace 1` reports its per-layer
metrics: from the harness's clock over a window of that length (spans
off), from a `torch.profiler` trace of a shorter stretch (spans off), and
from the program's spans (`gen_fvgn_tpu_torch/utils/spans.py`, read by
`harness/spans.py`), turned on in set-up, in a second profiled stretch
(each device operation charged to the span that launched it, the idle
gaps named by span) and in four third stretches, unprofiled, spans off,
on, on, off (host ms by span; the cost of the spans). The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device, (breakdown, program), checks. The numbers compared, each beside
its limit, are also the last lines of standard error.

Needs the CUDA cards the cell asks for; the program is the package
`gen_fvgn_tpu_torch`, and nothing here loads JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "gen_fvgn_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that must not be there, compared
    whole (the program's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def recorded(fn, *args) -> list:
    """Runs `fn(*args)` with the program's spans on; the spans it
    recorded."""
    from gen_fvgn_tpu_torch.utils import spans
    spans.take()
    spans.enable(True)
    try:
        fn(*args)
    finally:
        spans.enable(False)
    return spans.take()


def third_stretches(drv) -> dict:
    """One pass over the pool (train) or one whole request (rollout), four
    times: spans off, on, on, off. The wall seconds of each and the spans
    recorded."""
    from benchmark.harness import cells
    steps = drv.dataset // drv.batch if drv.mode == "train" else drv.steps
    third = {"steps": steps, True: [], False: [], "spans": []}
    for on in (False, True, True, False):
        cells.sync(drv.dev)
        t0 = time.perf_counter()
        if on:
            third["spans"] += recorded(drv.stretch, steps)
        else:
            drv.stretch(steps)
        cells.sync(drv.dev)
        third[on].append(time.perf_counter() - t0)
    return third


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t0: float = T0, cell=None):
    """One run of a cell on `device` (`cell`: a `spec.Cell` in place of
    the one BENCHMARK.json names). Returns (result, lines for standard
    error)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import cells, check, flops, spec
    from benchmark.harness import spans as hs
    from benchmark.harness import trace as tr

    cell = cell or spec.load_cell(workload)
    train = cell.traffic["mode"] == "train"
    drv = (cells.Train if train else cells.Rollout)(cell, seed, device)
    cuda = torch.device(device).type == "cuda"
    got = {}
    try:
        if trace:
            got["setup"] = recorded(drv.setup)
        else:
            drv.setup()
        setup_s = time.perf_counter() - t0
        win = drv.window(seconds)
        prof_sum, p_steps = {}, int(cell.traffic["trace_steps"])
        if trace and cuda:
            cells.sync(drv.dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                cells.sync(drv.dev)
                t_a = time.perf_counter()
                drv.stretch(p_steps)
                cells.sync(drv.dev)
                wall = time.perf_counter() - t_a
            prof_sum = tr.reduce_device(prof, p_steps, wall)
            prof_sum["host_step_s"] = wall / p_steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(tr.STRETCH):
                    cells.sync(drv.dev)
                    got["profiled"] = recorded(drv.stretch,
                                               max(1, p_steps // 3))
                    cells.sync(drv.dev)
            evs = list(prof.profiler.kineto_results.events())
            prof_sum["idle_gaps"] = tr.idle_gaps(prof)
            got["attribution"] = hs.attribute(*hs.from_kineto(evs))
            got["gaps"] = hs.name_gaps(evs)
            del prof, evs
        peak = int(torch.cuda.max_memory_allocated(drv.dev)) if cuda else 0
        if trace:
            got["third"] = third_stretches(drv)
        drv.free()

        st, numbers, _, details = check.compare(drv, cell, seed)
        # a step whose answer is not finite is wrong, sampled or not
        correct = check.judge(numbers, cell.limits) and not win["failed"]

        mesh = {"n_nodes": st.n_nodes, "n_faces": st.face_node.shape[1],
                "n_cells": st.n_cells, "n_slots": st.slot_node.shape[0],
                "n_stencil": st.st_out.shape[0]}
        n_params = sum(v.numel() for v in drv.weights0.values())
        run = {"mode": cell.traffic["mode"], "trace": trace,
               "setup_s": setup_s, "statics_s": drv.statics_s,
               "window": win, "profile": prof_sum, "profile_steps": p_steps,
               "ops": flops.step_ops(cell.cfg, mesh, drv.batch, train,
                                     n_params)}
        if trace:
            run["program"] = hs.program_record(got)
        wanted = cell.per_layer if trace else cell.end_to_end
        metrics = {}
        for m in wanted:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info = {"platform": "gpu" if cuda else drv.dev.type,
                    "kind": (torch.cuda.get_device_name(drv.dev) if cuda
                             else drv.dev.type),
                    "count": cell.chips, "memory_peak_bytes": peak}
        if trace and prof_sum.get("busy_s"):
            dev_info["busy_s"] = prof_sum["busy_s"]
            dev_info["window_s"] = prof_sum["window_s"]
        result = {"correct": correct, "attempted": int(win["steps"]),
                  "failed": int(win["failed"]), "metrics": metrics,
                  "device": dev_info}
        if trace and prof_sum.get("device_ops"):
            result["breakdown"] = {"device_ops": prof_sum["device_ops"],
                                   "idle_gaps": prof_sum["idle_gaps"]}
        if trace:
            result["program"] = run["program"]
        result["checks"] = {k: {"value": numbers.get(k), "limit": v}
                            for k, v in cell.limits.items()}
        lines = [f"detail {d}" for d in details]
        lines += [f"detail {k} (not compared): {v!r}"
                  for k, v in numbers.items() if k not in cell.limits]
        if prof_sum.get("busy_s") and win["steps"]:
            lines.append(
                f"detail traced stretch {1e3 * prof_sum['host_step_s']!r} "
                f"ms a step, busy {1e3 * prof_sum['busy_s'] / p_steps!r}; "
                f"untraced {1e3 * win['seconds'] / win['steps']!r}")
        if trace:
            lines += hs.detail_lines(run["program"], run["mode"], win)
        lines += [f"check {k}: {numbers.get(k)!r} (limit {v!r})"
                  for k, v in cell.limits.items()]
        lines.append(f"check correct: {correct}")
        return result, lines
    finally:
        drv.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness import spec
    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result, lines = execute(args.workload, args.seed, args.seconds,
                            bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
