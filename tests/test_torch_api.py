"""PyTorch port, the small API functions the JAX package has beside its
engines: `gen_fvgn_tpu_torch.train` at the package top,
`io/tecplot.py::write_tecplot_async`, `training/normalizer.py::inverse`,
`ops/blocksparse.py::apply_linop_multi` and `ops/wlsq.py::column_degrees`,
each against the JAX function."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import (f32_operator_statics, jax_norm_state,
                               numpy_norm_stats, torch_norm_state)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)


def test_package_top_train_is_the_loop(monkeypatch):
    """`from gen_fvgn_tpu_torch import train`, as `from gen_fvgn_tpu
    import train`: the training loop, imported when first called, with
    every argument passed on."""
    import gen_fvgn_tpu
    import gen_fvgn_tpu_torch
    from gen_fvgn_tpu_torch.training import loop
    assert "train" in gen_fvgn_tpu_torch.__all__
    assert set(gen_fvgn_tpu_torch.__all__) == set(gen_fvgn_tpu.__all__)
    calls = []
    monkeypatch.setattr(loop, "train", lambda *a, **k: calls.append((a, k))
                        or "state")
    assert gen_fvgn_tpu_torch.train("cfg", cases=[1], device="cpu") == \
        "state"
    assert calls == [(("cfg",), dict(cases=[1], device="cpu"))]


@pytest.mark.parametrize("kind", ["quad", "tri"])
def test_write_tecplot_async_matches_jax(tmp_path, kind, monkeypatch):
    """The zone the child process writes is the JAX async writer's, byte
    for byte (JAX `tests/test_io.py::test_tecplot_async_writer`); the
    pickled arguments are gone once the child is done. Both writers put
    their pickles in a temporary directory of this test's own, so that a
    pickle of another test's writer running at the same time is not
    counted."""
    import tempfile

    from gen_fvgn_tpu.io.tecplot import write_tecplot_async as jwrite
    from gen_fvgn_tpu_torch.io.tecplot import write_tecplot_async
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     cavity_tri_mesh)
    mesh = (cavity_quad_mesh if kind == "quad" else cavity_tri_mesh)(3)
    n = mesh["node|pos"].shape[0]
    kw = dict(pos=mesh["node|pos"], cells_node=mesh["cells_node"],
              cells_index=mesh["cells_index"],
              variables={"U": np.linspace(0.0, 1.0, n), "P": np.ones(n)},
              zone_title=kind, solution_time=1.5)
    own = tmp_path / "tmp"
    own.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(own))
    before = set(os.listdir(own))
    mine = write_tecplot_async(str(tmp_path / "port" / "a.dat"), **kw)
    ref = jwrite(str(tmp_path / "jax" / "a.dat"), **kw)
    assert mine.wait(timeout=120) == 0 and ref.wait(timeout=120) == 0
    got = open(tmp_path / "port" / "a.dat").read()
    assert got == open(tmp_path / "jax" / "a.dat").read()
    assert ("FEQUADRILATERAL" if kind == "quad" else "FETRIANGLE") in got
    left = set(os.listdir(own)) - before
    assert not [f for f in left if f.endswith(".pkl")]


def test_normalizer_inverse_matches_jax():
    """`inverse` against the JAX function on the same statistics, and the
    inverse of `normalize` (without accumulation) within float32."""
    from gen_fvgn_tpu.training.normalizer import inverse as jinverse
    from gen_fvgn_tpu_torch.training.normalizer import inverse, normalize
    stats = numpy_norm_stats()
    x = np.random.default_rng(3).normal(size=(2, 7, 9)).astype(np.float32)
    got = inverse(torch_norm_state(stats), torch.from_numpy(x)).numpy()
    ref = np.asarray(jinverse(jax_norm_state(stats), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    state = torch_norm_state(stats)
    y, _ = normalize(state, torch.from_numpy(x), torch.ones(2, 7, dtype=bool),
                     max_accumulations=10.0, accumulate=False)
    np.testing.assert_allclose(inverse(state, y).numpy(), x, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("op", ["adj", "edge_diff", "wlsq"])
def test_apply_linop_multi_matches_jax(op):
    """An operator applied to [n_in, 3, 4] (the trailing axes as one lane
    axis), against the JAX function on the same mesh's operator (float32
    operators on both sides)."""
    from gen_fvgn_tpu.ops.blocksparse import apply_linop_multi as japply
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop_multi
    js, ts = f32_operator_statics()
    top, jop = getattr(ts.ops, op), getattr(js.ops, op)
    x = np.random.default_rng(1).normal(
        size=(top.fwd.n_in, 3, 4)).astype(np.float32)
    got = apply_linop_multi(top, torch.from_numpy(x)).numpy()
    ref = np.asarray(japply(jop, jnp.asarray(x)))
    assert got.shape == (top.fwd.n_out, 3, 4)
    np.testing.assert_allclose(got, ref[:top.fwd.n_out], rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("order", ["1st", "2nd", "3rd", "4th"])
def test_column_degrees_matches_jax(order):
    from gen_fvgn_tpu.ops.wlsq import column_degrees as jdeg
    from gen_fvgn_tpu_torch.ops.wlsq import column_degrees, column_degrees_xy
    got = column_degrees(order)
    np.testing.assert_array_equal(got, np.asarray(jdeg(order)))
    dx, dy = column_degrees_xy(order)
    np.testing.assert_array_equal(got, dx + dy)


def test_train_takes_pad_multiple_and_progress_every(tmp_path, monkeypatch):
    """The two `train()` arguments of the JAX loop the port had dropped:
    the segment pool pads to multiples of `pad_multiple` (8 here, not the
    default 128), and the loss monitor takes a row every `progress_every`
    epochs (epochs 0 and 2 of 3), as the JAX loop's."""
    import glob

    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training import loop
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    pools = []
    orig = EnvPool.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        pools.append(self)
    monkeypatch.setattr(EnvPool, "__init__", init)
    case = synthetic_case(cavity_quad_mesh(4), continuity=1, convection=1,
                          grad_p=1, mu=0.05, sigma=(1, 1, 1))
    cfg = Config(net="FVGN", hidden_size=32, message_passing_num=1,
                 mxu_dtype="float32", batch_size=2, dataset_size=2,
                 max_inner_steps=1)
    state = loop.train(cfg, cases=[case], log_base_dir=str(tmp_path),
                       n_epochs=3, pad_multiple=8, progress_every=2,
                       device="cpu")
    assert state.epoch == 3
    pool, = pools
    n_nodes = case["mesh"]["node|pos"].shape[0]
    assert pool.sizes.n_nodes == -(-n_nodes // 8) * 8 < 128
    monitor, = glob.glob(str(tmp_path / "*" / "*" / "Loss_monitor.dat"))
    rows = open(monitor).read().strip().splitlines()[1:]
    assert [int(float(r.split(",")[0])) for r in rows] == [0, 2]
