"""PyTorch port, the command-line entry points `gen_fvgn_tpu_torch.scripts.
pre_train` and `.solve`: the same Config and case list as the JAX scripts
from the same argv, a run end to end on the CPU from case directories on
disk (training in both batching modes, then the three solve modes from its
checkpoint), `solve` at its default engine (segment) from a checkpoint of
either engine's `pre_train`, the flags that are not ported yet, and the
package without h5py. Cases: cavities of 5x5 and 6x6 nodes written by
`gen_fvgn_tpu_torch/tools/case_files.py`."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(root):
    """Two case directories and a directory without BC.json."""
    from gen_fvgn_tpu_torch.tools.case_files import write_cavity_case
    root = str(root)
    write_cavity_case(os.path.join(root, "lid", "quad"), n=4)
    write_cavity_case(os.path.join(root, "channel_tri"), n=5, kind="tri",
                      boundary="channel")
    os.makedirs(os.path.join(root, "notes"), exist_ok=True)
    return root


def _capture(monkeypatch, module, name):
    calls = []
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append((a, k)))
    return calls


PRE_TRAIN_ARGV = {
    "defaults": [],
    "every_flag": ["--log-dir", "L", "--net", "FVGN", "--epochs", "7",
                   "--batch-size", "4", "--dataset-size", "12", "--lr",
                   "1e-3", "--order", "3rd", "--integrator", "explicit",
                   "--conserved-form", "0", "--max-inner-steps", "5",
                   "--seed", "3", "--mxu-dtype", "float32", "--engine",
                   "block", "--resume", "x.state", "--bucket-tiers", "1",
                   "--export-on-reset", "1", "--microbatch", "2",
                   "--mixed-case-batches", "1", "--tensorboard", "1"],
    "segment": ["--engine", "segment", "--batch-size", "2"],
}


@pytest.mark.parametrize("extra", list(PRE_TRAIN_ARGV.values()),
                         ids=list(PRE_TRAIN_ARGV))
def test_pre_train_builds_the_jax_config_and_cases(tmp_path, monkeypatch,
                                                   extra):
    """The same argv gives the JAX script and the port's the same Config
    (field by field), case list and run arguments; `train` is replaced in
    both packages, so nothing trains."""
    import gen_fvgn_tpu.training.loop as jloop
    import gen_fvgn_tpu_torch.training.loop as tloop
    from gen_fvgn_tpu_torch.scripts import pre_train
    from scripts.pre_train import main as jmain
    monkeypatch.setenv("GFVGN_JAX_CACHE", str(tmp_path / "jax_cache"))
    argv = ["--dataset-dir", _dataset(tmp_path / "data")] + extra
    jcalls = _capture(monkeypatch, jloop, "train")
    tcalls = _capture(monkeypatch, tloop, "train")
    jmain(argv)
    pre_train.main(argv + ["--device", "cpu"])
    ((jcfg,), jkw), = jcalls
    ((tcfg,), tkw), = tcalls
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    assert tkw.pop("device") == "cpu"
    assert tkw == jkw
    assert [os.path.relpath(d, str(tmp_path / "data"))
            for d in tkw["case_dirs"]] == ["channel_tri", "lid/quad"]


def test_solve_builds_the_jax_config(tmp_path, monkeypatch):
    import scripts.solve as jsolve
    from gen_fvgn_tpu_torch.scripts import solve
    monkeypatch.setenv("GFVGN_JAX_CACHE", str(tmp_path / "jax_cache"))
    argv = ["--case", "c", "--checkpoint", "s.state", "--mode", "lbfgs",
            "--steps", "3", "--inner-steps", "4", "--out-dir", "o",
            "--order", "1st", "--net", "FVGN", "--engine", "block"]
    jcalls = _capture(monkeypatch, jsolve, "_solve_block")
    tcalls = _capture(monkeypatch, solve, "_solve_block")
    jsolve.main(argv)
    solve.main(argv + ["--device", "cpu"])
    ((jcfg, jargs), _), = jcalls
    ((tcfg, targs), _), = tcalls
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    t = vars(targs)
    assert t.pop("device") == "cpu" and t == vars(jargs)


@pytest.mark.parametrize("mixed", ["0", "1"], ids=["stratified", "mixed"])
def test_pre_train_then_solve_on_the_cpu(tmp_path, mixed):
    """pre_train on the two case directories (2 epochs of 2 inner steps,
    TransFVGN_v2 at the Config's widths, float32), then solve from its last
    checkpoint in each mode: the loss monitor, both checkpoint slots, the
    TensorBoard events and two solution files a mode."""
    from gen_fvgn_tpu_torch.scripts import pre_train, solve
    data = _dataset(tmp_path / "data")
    runs = str(tmp_path / "runs")
    pre_train.main(["--dataset-dir", data, "--log-dir", runs, "--epochs", "2",
                    "--batch-size", "2", "--dataset-size", "4",
                    "--max-inner-steps", "2", "--mxu-dtype", "float32",
                    "--mixed-case-batches", mixed, "--tensorboard", "1",
                    "--device", "cpu"])
    run_dir, = glob.glob(os.path.join(runs, "*", "*"))
    lines = open(os.path.join(run_dir, "Loss_monitor.dat")).read().split()
    rows = [[float(v) for v in ln.split(",")] for ln in lines[1:]]
    assert len(rows) == 2 and np.isfinite(rows).all()
    assert sorted(os.listdir(os.path.join(run_dir, "states"))) == \
        ["0.state", "1.state"]
    assert len(os.listdir(os.path.join(run_dir, "tb"))) == 1
    state = os.path.join(run_dir, "states", "1.state")
    for mode in ("rollout", "adam", "lbfgs"):
        out = str(tmp_path / f"solve_{mode}")
        solve.main(["--case", os.path.join(data, "channel_tri"),
                    "--engine", "block", "--checkpoint", state, "--mode",
                    mode, "--steps", "2", "--inner-steps", "2", "--out-dir",
                    out, "--device", "cpu"])
        files = sorted(os.listdir(out))
        assert files == ["step_00000.dat", "step_00001.dat"], mode
        text = open(os.path.join(out, files[-1])).read()
        assert '"U"' in text and "FEPOLYGON" in text and "nan" not in text


@pytest.mark.parametrize("train_engine", ["segment", "block"])
def test_solve_at_its_default_engine_on_the_cpu(tmp_path, train_engine):
    """pre_train with `--engine segment` (or the block engine, pre_train's
    default), then `solve` with no `--engine` (the segment engine, its
    default) from the run's last checkpoint in each mode: a checkpoint of
    either engine serves the segment nets (one parameter tree). The loss
    monitor, both slots, and two finite solution files a mode."""
    from gen_fvgn_tpu_torch.scripts import pre_train, solve
    data = _dataset(tmp_path / "data")
    runs = str(tmp_path / "runs")
    pre_train.main(["--dataset-dir", data, "--log-dir", runs, "--epochs", "2",
                    "--batch-size", "2", "--dataset-size", "4",
                    "--max-inner-steps", "2", "--mxu-dtype", "float32",
                    "--engine", train_engine, "--device", "cpu"])
    run_dir, = glob.glob(os.path.join(runs, "*", "*"))
    lines = open(os.path.join(run_dir, "Loss_monitor.dat")).read().split()
    rows = [[float(v) for v in ln.split(",")] for ln in lines[1:]]
    assert len(rows) == 2 and np.isfinite(rows).all()
    assert json.load(open(os.path.join(run_dir, "config.json")))[
        "engine"] == train_engine
    assert sorted(os.listdir(os.path.join(run_dir, "states"))) == \
        ["0.state", "1.state"]
    state = os.path.join(run_dir, "states", "1.state")
    for mode in ("rollout", "adam", "lbfgs"):
        out = str(tmp_path / f"solve_{mode}")
        solve.main(["--case", os.path.join(data, "channel_tri"),
                    "--checkpoint", state, "--mode", mode, "--steps", "2",
                    "--inner-steps", "2", "--out-dir", out, "--device",
                    "cpu"])
        files = sorted(os.listdir(out))
        assert files == ["step_00000.dat", "step_00001.dat"], mode
        text = open(os.path.join(out, files[-1])).read()
        assert '"U"' in text and "FEPOLYGON" in text and "nan" not in text


@pytest.mark.parametrize("cli,argv,exc,match", [
    ("pre_train", ["--engine", "segment", "--bucket-tiers", "1",
                   "--dp-devices", "2"], RuntimeError, "torchrun"),
    ("pre_train", ["--dp-devices", "2"], RuntimeError, "torchrun"),
    ("pre_train", ["--sp-devices", "2"], RuntimeError,
     "sp_devices=2 needs .* world size 2 .*torchrun"),
    ("solve", ["--sp-devices", "2"], SystemExit, "--engine block"),
    ("solve", ["--engine", "block", "--sp-devices", "2"], RuntimeError,
     "sp_devices=2 needs .* world size 2 .*torchrun")],
    ids=["pre_train-segment", "pre_train-dp", "pre_train-sp",
         "solve-segment-default", "solve-sp"])
def test_unported_flags_raise(tmp_path, cli, argv, exc, match):
    """A flag that needs more ranks than the process has raises before
    anything is read: `--dp-devices 2` or `--sp-devices 2` outside a
    process group of 2 ranks raises a RuntimeError that names the grid
    and the world size and says to launch under torchrun (on the segment
    engine with its bucket tiers too; pre_train and solve --engine block
    alike). At solve's default engine, the segment engine, `--sp-devices`
    exits before anything is read, as the JAX script does (the segment
    engine has no sharded form in either package)."""
    from gen_fvgn_tpu_torch.scripts import pre_train, solve
    missing = str(tmp_path / "missing")
    if cli == "pre_train":
        run = lambda: pre_train.main(["--dataset-dir", missing] + argv)
    else:
        run = lambda: solve.main(["--case", missing] + argv)
    with pytest.raises(exc, match=match) as err:
        run()
    if exc is NotImplementedError:
        assert "later slice" in str(err.value)


_NO_H5PY = """
import importlib, os, sys
sys.modules["h5py"] = None           # `import h5py` raises ImportError
root, data, out = sys.argv[1:4]
mods = []
for dirpath, _, files in os.walk(os.path.join(root, "gen_fvgn_tpu_torch")):
    for f in files:
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
            mods.append(rel.replace(os.sep, ".").replace(".__init__", ""))
for m in mods:
    importlib.import_module(m)
from gen_fvgn_tpu_torch.scripts import pre_train, solve
pre_train.main(["--dataset-dir", data, "--log-dir", out, "--epochs", "1",
                "--batch-size", "2", "--dataset-size", "2",
                "--max-inner-steps", "1", "--mxu-dtype", "float32",
                "--net", "FVGN", "--device", "cpu"])
state = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs
         if f.endswith(".state")][0]
case = os.path.join(data, "channel_tri")
solve.main(["--case", case, "--engine", "block", "--net", "FVGN",
            "--checkpoint", state, "--steps", "1", "--out-dir",
            os.path.join(out, "solve"), "--device", "cpu"])
from gen_fvgn_tpu_torch.meshes.hdf5 import read_mesh_h5, write_mesh_h5
from gen_fvgn_tpu_torch.training.pool import load_case
for call in (lambda: write_mesh_h5({}, os.path.join(out, "w.h5"), "w"),
             lambda: read_mesh_h5(os.path.join(case, "x.h5"))):
    try:
        call()
    except ImportError as exc:
        assert ".h5" in str(exc) and "h5py" in str(exc), exc
    else:
        raise AssertionError("no ImportError without h5py")
open(os.path.join(case, "channel_tri.h5"), "wb").close()
try:
    load_case(case)      # the .mphtxt is there too: no fallback to it
except ImportError as exc:
    assert "channel_tri.h5" in str(exc), exc
else:
    raise AssertionError("a .h5 case loaded without h5py")
print("OK", sorted(os.listdir(os.path.join(out, "solve"))))
"""


def test_package_and_clis_without_h5py(tmp_path):
    """With h5py blocked from import: every module of the port imports,
    pre_train and solve run from `.mphtxt` case directories, and a `.h5`
    (read, write, or a case directory that holds one) raises ImportError
    naming the file, never reading the case's other mesh file instead."""
    data = _dataset(tmp_path / "data")
    res = subprocess.run(
        [sys.executable, "-c", _NO_H5PY, ROOT, data, str(tmp_path / "out")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK ['step_00000.dat']" in res.stdout
