"""PyTorch port, the run's files: the Tecplot writer and `export_env`
byte for byte against the JAX package's, the run logger's layout and its
`Loss_monitor.dat` byte for byte, and the checkpoint (`save_state`,
`load_state`, `RotatingCheckpointer`): a bit-exact round trip, slots
`epoch % 3`, a refused structure, and a resumed step equal to the
uninterrupted one, bit for bit."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import both_sides, jax_side, torch_side
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

SMALL = (6, 32, 1, "float32", 2)


def _mixed_mesh(pkg):
    """A cavity whose even cells are split into two triangles: a mixed
    tri/quad mesh, compiled by package `pkg`."""
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    geo = importlib.import_module(f"{pkg}.meshes.geometry")
    quad = syn.cavity_quad_mesh(4)
    cells = quad["cells_node"].reshape(-1, 4)
    nodes, index = [], []
    for c, (a, b, cc, d) in enumerate(cells):
        parts = [[a, b, cc], [a, cc, d]] if c % 2 == 0 else [[a, b, cc, d]]
        for part in parts:
            index += [len(set(index))] * len(part)
            nodes += part
    return geo.compile_mesh({
        "node|pos": quad["node|pos"], "node|node_type": quad["node|node_type"],
        "node|surf_mask": quad["node|surf_mask"],
        "cells_node": np.asarray(nodes, np.int64),
        "cells_index": np.asarray(index, np.int64)})


@pytest.mark.parametrize("kind", ["quad", "mixed"])
def test_tecplot_zone_is_byte_identical_to_jax(tmp_path, kind):
    from gen_fvgn_tpu.io.tecplot import write_tecplot_zone as jwrite
    from gen_fvgn_tpu_torch.io.tecplot import write_tecplot_zone as twrite
    if kind == "quad":
        from gen_fvgn_tpu_torch.meshes.synthetic import cavity_quad_mesh
        mesh, poly = cavity_quad_mesh(5), {}
    else:
        mesh = _mixed_mesh("gen_fvgn_tpu_torch")
        assert len(set(np.bincount(mesh["cells_index"]))) == 2
        poly = dict(face_node=mesh["face|face_node"],
                    neighbour_cell=mesh["face|neighbour_cell"])
    rng = np.random.default_rng(0)
    n, c = mesh["node|pos"].shape[0], mesh["cell|centroid"].shape[0]
    variables = {"U": rng.normal(size=n).astype(np.float32),
                 "P": rng.normal(size=(n, 1)),
                 "grad": rng.normal(size=(c, 2)).astype(np.float32)}
    kw = dict(variables=variables, zone_title="z", solution_time=3.0, **poly)
    args = (mesh["node|pos"], mesh["cells_node"], mesh["cells_index"])
    jwrite(str(tmp_path / "jax.dat"), *args, **kw)
    twrite(str(tmp_path / "port" / "port.dat"), *args, **kw)
    mine = (tmp_path / "port" / "port.dat").read_bytes()
    assert mine == (tmp_path / "jax.dat").read_bytes()
    assert (b"FEPOLYGON" in mine) == (kind == "mixed")
    if kind == "mixed":
        with pytest.raises(ValueError, match="FEPOLYGON"):
            twrite(str(tmp_path / "x.dat"), *args, variables=variables)


def test_export_env_is_byte_identical_to_jax(tmp_path):
    """The same state in both pools: the same file name and bytes."""
    (_, jpool, _, jdyn), (_, tpool, _, _) = jax_side(*SMALL), \
        torch_side(*SMALL)
    uvp = np.random.default_rng(1).normal(
        size=tuple(jdyn.uvp.shape)).astype(np.float32)
    idxs = np.arange(2)
    jpool.payback_block(idxs, jnp.asarray(uvp))
    tpool.payback_block(idxs, torch.from_numpy(uvp))
    jp = jpool.export_env(1, str(tmp_path / "jax"), tag="_t")
    tp = tpool.export_env(1, str(tmp_path / "port"), tag="_t")
    assert os.path.basename(tp) == os.path.basename(jp)
    assert os.path.basename(tp).endswith("_t_age1.dat")
    assert open(tp, "rb").read() == open(jp, "rb").read()
    np.testing.assert_array_equal(tpool.host_uvp(1), uvp[1])


def test_loss_monitor_and_run_files_match_jax(tmp_path):
    """The same scalars (a change of columns included): Loss_monitor.dat,
    config.json and seed.txt byte for byte; the same directory layout."""
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.io.logger import RunLogger as JLogger
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.io.logger import RunLogger, hyperparam_tag
    loggers = [cls(str(tmp_path / side), cfg(net="FVGN", hidden_size=64),
                   copy_code=False, seed=7, run_name="run")
               for side, cls, cfg in (("jax", JLogger, JConfig),
                                      ("port", RunLogger, Config))]
    rows = [(0, {"loss": 1.25, "lr": np.float32(5e-5)}),
            (1, {"loss": -3.5e-9, "lr": 1e-6}),
            (2, {"loss": 2.0, "lr": 1e-6, "epoch_seconds": 0.125})]
    for step, scalars in rows:
        for lg in loggers:
            lg.log_scalars(step, scalars)
    jl, tl = loggers
    assert os.path.relpath(tl.run_dir, tmp_path / "port") == \
        os.path.relpath(jl.run_dir, tmp_path / "jax") == \
        os.path.join(hyperparam_tag(Config(net="FVGN", hidden_size=64)), "run")
    for name in ("Loss_monitor.dat", "config.json", "seed.txt"):
        assert open(os.path.join(tl.run_dir, name), "rb").read() == \
            open(os.path.join(jl.run_dir, name), "rb").read(), name
    assert os.path.isdir(tl.states_dir) and tl.results_dir.endswith(
        "traing_results")


def test_code_snapshot_leaves_out_builds_and_tensorboard_raises(tmp_path):
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.io.logger import RunLogger
    lg = RunLogger(str(tmp_path), Config(), seed=0, run_name="r")
    snap = os.path.join(lg.run_dir, "code_snapshot", "gen_fvgn_tpu_torch")
    found = {d for _, dirs, _ in os.walk(snap) for d in dirs}
    assert "csrc" in found and "training" in found
    assert not found & {"_build", "__pycache__"}
    assert os.path.isfile(os.path.join(snap, "training", "loop.py"))
    # TensorBoard is ported now (tests/test_torch_readers.py holds its
    # events against the JAX writer's): the logger makes its event file
    tb = RunLogger(str(tmp_path), Config(), run_name="tb",
                   use_tensorboard=True)
    tb.log_scalars(0, {"loss": 1.0})
    tb.close()
    assert len(os.listdir(os.path.join(tb.run_dir, "tb"))) == 1


def _state(seed=0, hidden=32, steps=2):
    """A port TrainState (FVGN, CPU) after `steps` train steps, so that its
    Adam moments and normalizer are not their initial values; with the
    step function and the batch."""
    from gen_fvgn_tpu_torch.training.train_block import (
        init_train_state_block, make_train_step_block)
    _, (tc, tpool, tstatic, tdyn) = both_sides(*SMALL)
    cfg = tc.replace(hidden_size=hidden)
    state, sim = init_train_state_block(cfg, seed=seed, device="cpu")
    step = make_train_step_block(cfg, sim, device="cpu")
    for _ in range(steps):
        state, _, _ = step(state, tdyn, tstatic)
    return state, step, (tdyn, tstatic)


def _flat_state(state):
    from gen_fvgn_tpu_torch.io.checkpoint import state_dict
    out = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(obj, torch.Tensor):
            out[prefix] = obj.clone()
        elif isinstance(obj, (int, float)):
            out[prefix] = obj
    walk("", state_dict(state))
    return out


def _bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    from gen_fvgn_tpu_torch.io.checkpoint import load_state, save_state
    state, _, _ = _state()
    state.epoch = 7
    path = str(tmp_path / "s" / "a.state")
    save_state(state, path)
    assert os.listdir(tmp_path / "s") == ["a.state"]     # no temporary left
    fresh, _, _ = _state(seed=1, steps=0)
    assert fresh.optimizer.state_dict()["state"] == {}
    got = load_state(path, like=fresh)
    assert got is fresh and got.epoch == 7 and got.step == 2
    _bit_equal(_flat_state(got), _flat_state(state))
    n_moments = sum(1 for k in _flat_state(got) if k.endswith("exp_avg_sq"))
    assert n_moments == len(list(state.simulator.parameters()))


def test_rotating_slots_follow_epoch_mod_3(tmp_path):
    from gen_fvgn_tpu_torch.io.checkpoint import RotatingCheckpointer
    state, _, _ = _state(steps=0)
    ckpt = RotatingCheckpointer(str(tmp_path / "states"))
    assert ckpt.latest() is None
    for epoch in range(5):
        state.epoch = epoch
        assert ckpt.save(state, epoch).endswith(f"{epoch % 3}.state")
    assert sorted(os.listdir(tmp_path / "states")) == \
        ["0.state", "1.state", "2.state"]
    epochs = {f: torch.load(str(tmp_path / "states" / f),
                            weights_only=True)["epoch"]
              for f in os.listdir(tmp_path / "states")}
    assert epochs == {"0.state": 3, "1.state": 4, "2.state": 2}
    assert ckpt.latest().endswith("1.state")


def test_checkpoint_of_another_structure_raises_and_loads_nothing(tmp_path):
    from gen_fvgn_tpu_torch.io.checkpoint import load_state, save_state
    state, _, _ = _state(steps=1)
    path = str(tmp_path / "a.state")
    save_state(state, path)
    other, _, _ = _state(seed=3, hidden=16, steps=0)
    before = _flat_state(other)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, like=other)
    _bit_equal(_flat_state(other), before)
    # the same shapes under another name
    stored = torch.load(path, weights_only=True)
    sd = stored["simulator"]
    key = sorted(sd)[0]
    sd[key + "_renamed"] = sd.pop(key)
    torch.save(stored, path)
    same, _, _ = _state(seed=3, steps=0)
    with pytest.raises(ValueError, match="renamed"):
        load_state(path, like=same)


def test_resumed_step_equals_the_uninterrupted_step(tmp_path):
    from gen_fvgn_tpu_torch.io.checkpoint import load_state, save_state
    state, step, (dyn, static) = _state(steps=3)
    path = str(tmp_path / "a.state")
    save_state(state, path)
    state, m1, u1 = step(state, dyn, static)
    fresh, fstep, _ = _state(seed=4, steps=0)
    fresh = load_state(path, like=fresh)
    fresh, m2, u2 = fstep(fresh, dyn, static)
    assert torch.equal(m1.loss, m2.loss) and torch.equal(u1, u2)
    _bit_equal(_flat_state(fresh), _flat_state(state))
