"""A cell of `BENCHMARK.json` and the data files it names.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name:

* `benchmark/configs/<config>.json`: the system's Config, its source, what
  was reduced and what was assumed (the boundary-condition ranges);
* `benchmark/workloads/<traffic>.json`: the traffic (mode, engine, mesh,
  batch, pool size, steps a request);
* `benchmark/limits/<cell>.json`: the limits of the numbers the cell's
  check compares;
* `benchmark/metrics/<metric>.py`: the reader of one metric;
* `benchmark/reference/nets/<net>.py`: one network (the Config's `net`):
  its parameter layout, its plain reference forward (handed the node
  inputs, the edge features, the faces and the nodes' coordinates) and
  its operations, its input features among them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
NETS_DIR = BENCH_DIR / "reference" / "nets"


def _json(path: Path) -> Dict:
    with open(path, "rt") as f:
        return json.load(f)


def benchmark_file() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # the configuration file
    traffic: Dict         # the traffic file
    limits: Dict          # the cell's limits
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def cfg(self) -> Dict:
        """The system's Config fields."""
        return self.config["config"]


def _reported_in(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: Dict = None) -> Cell:
    bench = bench or benchmark_file()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(ROOT / conf["file"])
    traffic = _json(BENCH_DIR / "workloads" / f"{w['traffic']}.json")
    limits = _json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported_in(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def _load(path: Path, prefix: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable:
    """`read(run)` of `benchmark/metrics/<metric>.py`."""
    return _load(BENCH_DIR / "metrics" / f"{metric}.py", "benchmark_metric_",
                 metric).read


def net(name: str) -> ModuleType:
    """The module `benchmark/reference/nets/<name>.py` of the Config's
    `net`: `layout(cfg)`, `forward(net, x, e, face_node, pos)` and
    `forward_ops(cfg, mesh, batch)`."""
    path = NETS_DIR / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"the benchmark has no net {name!r}: add {path} "
                         "with layout(cfg), forward(net, x, e, face_node, "
                         "pos) and forward_ops(cfg, mesh, batch)")
    return _load(path, "benchmark_net_", name)
