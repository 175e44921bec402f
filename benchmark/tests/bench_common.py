"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: a 7x7
cavity, batch 2, a pool of 6, rollouts of 5 steps."""

import dataclasses

from benchmark.harness import spec


def tiny_cell(name: str):
    cell = spec.load_cell(name)
    tr = dict(cell.traffic, mesh={"kind": "cavity", "n": 6}, batch=2,
              dataset=6)
    if tr["mode"] == "rollout":
        tr.update(rollout_steps=5, warm_steps=2, trace_steps=3,
                  check_pairs=3)
    else:
        tr.update(trace_steps=2)
    return dataclasses.replace(cell, traffic=tr)


def cells_of(mode: str):
    return [w["name"] for w in spec.benchmark_file()["workloads"]
            if spec.load_cell(w["name"]).traffic["mode"] == mode]
