"""The harness finds every cell, configuration, traffic, limit and metric
of BENCHMARK.json from data, and the file keeps to the contract's form."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all((spec.ROOT / p).is_dir() for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_from_data(w):
    cell = spec.load_cell(w)
    assert cell.traffic["mode"] in ("train", "rollout")
    assert cell.traffic["engine"] in ("segment", "block")
    assert cell.chips == 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert set(cell.limits) <= ({"loss1_gap", "loss_gap", "state_gap",
                                 "grad_gap", "change_gap"}
                                if cell.traffic["mode"] == "train" else
                                {"node_gap", "cell_gap", "loss_gap"})
    assert cell.limits and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["end_to_end"]
                               + BENCH["per_layer"]])
def test_every_metric_has_a_reader(m):
    assert callable(spec.reader(m))


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in metrics + BENCH["workloads"]
             + BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"set-up", "entry", "model step", "kernels", "device"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_run_config(c):
    from gen_fvgn_tpu_torch.config import Config
    data = json.loads((spec.ROOT / c["file"]).read_text())
    assert data["reduced"] == c["reduced"] == []
    cfg = Config.from_json(json.dumps(data["config"]))
    assert json.loads(cfg.to_json()) == data["config"]
