"""Runs one cell as `run.py --trace 1` does, and reads the program's spans.

    python3 benchmark/run_spans.py --workload <cell> --seed <n> \
        --seconds <s>

Everything `run.py --trace 1` does, unchanged: its window and its first
profiled stretch run with the program's spans off (`run.execute` runs
them). Besides, with the spans of `gen_fvgn_tpu_torch/utils/spans.py` on:

1. set-up (`envs_s`);
2. `run.py`'s second profiled stretch: every kernel, copy and fill is
   charged to the program span that launched it, and the breakdown's
   idle gaps carry the program's names (`harness/spans.py`);
3. a third stretch, unprofiled, after the second: one pass over the pool
   (train) or one whole request of `rollout_steps` (rollout), for the host
   ms of each span; it runs four times, spans off, on, on, off, for the
   step's wall time with the spans on against off.

`harness/cells.py`'s `Train` and `Rollout` and `trace.idle_gaps` are
wrapped for the duration of the call to get at those stretches. The last line of
standard output is `run.py`'s result, with the span metrics of
`span_metrics.json` (readers in `benchmark/metrics/`, from the record's
`program`) added to `metrics` in the cells each lists, and the record's
`program`; standard error has `run.py`'s lines and the spans' own: the
device time charged to no span, the device operations that take most
time by span, the rollout's host + record + export against its wall time
a step, and the step with the spans on against off. The benchmark's command, `run.py`, does none of
this yet (PERF.md §7).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

METRICS_FILE = os.path.join(ROOT, "benchmark", "span_metrics.json")


def span_metrics():
    with open(METRICS_FILE) as f:
        return json.load(f)


def _spanned(base, got):
    """`base` (`cells.Train` or `cells.Rollout`) with the program's spans on
    in set-up, in the second stretch, and in a third stretch that runs
    before the program is dropped."""
    from benchmark.harness import cells
    from gen_fvgn_tpu_torch.utils import spans

    def recorded(fn, *args):
        spans.take()
        spans.enable(True)
        try:
            return fn(*args)
        finally:
            spans.enable(False)

    class Spanned(base):
        def setup(self):
            self.n_stretch = 0
            recorded(super().setup)
            got["setup"] = spans.take()

        def window(self, seconds):
            got["window"] = super().window(seconds)
            return got["window"]

        def stretch(self, steps):
            self.n_stretch += 1
            if self.n_stretch != 2:
                return super().stretch(steps)
            recorded(super().stretch, steps)
            got["profiled"] = spans.take()

        def free(self):
            if hasattr(self, "pool"):
                steps = (self.dataset // self.batch if self.mode == "train"
                         else self.steps)
                third = {"steps": steps, True: [], False: [], "spans": []}
                for on in (False, True, True, False):
                    cells.sync(self.dev)
                    t0 = time.perf_counter()
                    if on:
                        recorded(super().stretch, steps)
                    else:
                        super().stretch(steps)
                    cells.sync(self.dev)
                    third[on].append(time.perf_counter() - t0)
                    third["spans"] += spans.take()
                got["third"] = third
            super().free()
    return Spanned


def program_record(got):
    """The run record's `program`: set-up, device and host parts."""
    from benchmark.harness import spans as hs
    envs = [s.seconds for s in got["setup"] if s.name == "gfvgn.setup.envs"]
    prog = {"setup": {"envs_s": sum(envs) if envs else None}}
    if "attribution" in got and got.get("profiled"):
        prog["device"] = hs.device_summary(got["attribution"],
                                           got["profiled"])
        prog["gaps"] = got["gaps"]
    if "third" in got:
        third = got["third"]
        steps = third["steps"] * len(third[True])
        prog["host"] = hs.host_summary(third["spans"], steps, sum(third[True]))
        prog["host"]["off_wall_ms"] = 1e3 * sum(third[False]) / steps
    return prog


def detail_lines(prog, mode, window) -> list:
    lines = []
    dev, host = prog.get("device"), prog.get("host")
    if dev:
        lines.append(f"detail spans: device ms a step by span "
                     f"{json.dumps(dev['ms'], sort_keys=True)}; "
                     f"unattributed share {dev['unattributed']!r}")
        lines += [f"detail spans: {ms!r} ms a step in {where}: {op}"
                  for where, op, ms in dev["top"]]
        for op, where, s in prog["gaps"]:
            lines.append(f"detail spans: idle gap {1e3 * s!r} ms in "
                         f"{where} under {op}")
    if host:
        win_ms = (1e3 * window["seconds"] / window["steps"]
                  if window and window["steps"] else None)
        lines.append(f"detail spans: third stretches {host['wall_ms']!r} ms "
                     f"a step with {host['spans_per_step']!r} spans a step "
                     f"on, {host['off_wall_ms']!r} off (on / off - 1 = "
                     f"{host['wall_ms'] / host['off_wall_ms'] - 1:+.4%}); "
                     f"window {win_ms!r} ms a step, spans off")
        if mode == "rollout":
            ms = host["ms"]
            parts = sum(ms.get(f"gfvgn.rollout.{k}", 0.0)
                        for k in ("step", "record", "export"))
            lines.append(f"detail spans: host + record + export {parts!r} "
                         f"ms against {host['wall_ms']!r} ms a step")
    return lines


def execute(workload: str, seed: int, seconds: float, device: str = "cuda",
            cell=None):
    """`run.execute(..., trace=True)` with the program's spans (the
    module's docstring). Returns (result, lines)."""
    from benchmark import run
    from benchmark.harness import cells, spec
    from benchmark.harness import spans as hs
    from benchmark.harness import trace as tr

    cell = cell or spec.load_cell(workload)
    got = {}
    saved = (cells.Train, cells.Rollout, tr.idle_gaps)

    def idle_gaps(prof):
        evs = list(prof.profiler.kineto_results.events())
        got["attribution"] = hs.attribute(*hs.from_kineto(evs))
        got["gaps"] = hs.name_gaps(evs)
        return saved[2](prof)

    cells.Train = _spanned(saved[0], got)
    cells.Rollout = _spanned(saved[1], got)
    tr.idle_gaps = idle_gaps
    try:
        result, lines = run.execute(workload, seed, seconds, True,
                                    device=device, t0=T0, cell=cell)
    finally:
        cells.Train, cells.Rollout, tr.idle_gaps = saved
    mode = cell.traffic["mode"]
    prog = program_record(got)
    record = {"mode": mode, "trace": True, "program": prog}
    for m in span_metrics():
        if cell.name not in m["workloads"]:
            continue
        v = spec.reader(m["name"])(record)
        if v is not None:
            result["metrics"][m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
    result["program"] = prog
    return result, detail_lines(prog, mode, got.get("window")) + lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    from benchmark import run
    from benchmark.harness import spec
    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    print(f"card: {run.card_line()}", file=sys.stderr)
    result, lines = execute(args.workload, args.seed, args.seconds)
    bad = run.forbidden_modules()
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
