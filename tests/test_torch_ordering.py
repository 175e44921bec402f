"""PyTorch port, the Hilbert-curve mesh ordering: `graph/operators.py::
hilbert_order` and `rcm_reorder(method=...)`, `training/pool.py::
ensure_rcm(method=...)` and its process-wide override GFVGN_ORDERING,
against the JAX package's (`tests/test_ordering.py`): the same
permutation, bit for bit, and the same compiled mesh arrays; and the block
train step's loss under either ordering."""

import numpy as np
import pytest

from torch_port_common import CASE_KW
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

KEYS = ("node|pos", "node|node_type", "node|surf_mask", "cells_node",
        "cells_index", "cells_face", "face|face_node", "face|neighbour_cell",
        "face|face_type", "face|face_area", "face|face_center_pos",
        "cell|centroid", "cell|cells_area", "unit_norm_v", "face_node_x")


def _positions():
    rng = np.random.default_rng(0)
    from gen_fvgn_tpu_torch.meshes.synthetic import cavity_quad_mesh
    return {"random": rng.random((1500, 2)),
            "clustered": np.concatenate([rng.normal(size=(300, 2)) * 1e-3,
                                         rng.random((200, 2)) * 1e3]),
            "cavity": cavity_quad_mesh(9)["node|pos"],
            "all_zeros": np.zeros((64, 2)),
            "one_line": np.stack([np.linspace(0, 1, 50),
                                  np.zeros(50)], axis=1)}


@pytest.mark.parametrize("name", list(_positions()))
@pytest.mark.parametrize("bits", [16, 8])
def test_hilbert_order_matches_jax(name, bits):
    """The same permutation as the JAX function, bit for bit, and a
    permutation, including the degenerate positions (all equal, one
    line) of JAX's own test."""
    from gen_fvgn_tpu.graph.operators import hilbert_order as jorder
    from gen_fvgn_tpu_torch.graph.operators import hilbert_order
    pos = _positions()[name]
    got = hilbert_order(pos, bits=bits)
    np.testing.assert_array_equal(got, jorder(pos, bits=bits))
    assert sorted(got.tolist()) == list(range(pos.shape[0]))


def _mesh(pkg):
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    geo = importlib.import_module(f"{pkg}.meshes.geometry")
    return geo.compile_mesh(syn.cavity_tri_mesh(6))


@pytest.mark.parametrize("method,env,expect", [
    ("hilbert", None, "hilbert"), ("rcm", None, "rcm"),
    ("rcm", "hilbert", "hilbert"), ("hilbert", "rcm", "rcm")],
    ids=["hilbert", "rcm", "env-hilbert", "env-rcm"])
def test_ensure_rcm_matches_jax(monkeypatch, method, env, expect):
    """`ensure_rcm(mesh, method)` with GFVGN_ORDERING unset or set (which
    overrides `method`): the compiled mesh arrays of the JAX function
    under the same method and variable, exactly, and node positions in the
    order `expect` names."""
    from gen_fvgn_tpu.training.pool import ensure_rcm as jensure
    from gen_fvgn_tpu_torch.graph.operators import hilbert_order
    from gen_fvgn_tpu_torch.training.pool import ensure_rcm
    if env is None:
        monkeypatch.delenv("GFVGN_ORDERING", raising=False)
    else:
        monkeypatch.setenv("GFVGN_ORDERING", env)
    got = ensure_rcm(_mesh("gen_fvgn_tpu_torch"), method=method)
    ref = jensure(_mesh("gen_fvgn_tpu"), method=method)
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    base = _mesh("gen_fvgn_tpu_torch")["node|pos"]
    hil = base[hilbert_order(base)]
    assert np.array_equal(got["node|pos"], hil) == (expect == "hilbert")


def test_unknown_ordering_raises():
    from gen_fvgn_tpu_torch.graph.operators import rcm_reorder
    mesh = _mesh("gen_fvgn_tpu_torch")
    with pytest.raises(ValueError, match="unknown ordering"):
        rcm_reorder({k: mesh[k] for k in ("node|pos", "node|node_type",
                                          "cells_node", "cells_index")},
                    method="morton")


def test_block_loss_under_hilbert_ordering(monkeypatch):
    """The port's block pool under GFVGN_ORDERING=hilbert: the JAX pool's
    mesh under the same variable, and one train step's loss within 2e-4
    of the loss under RCM (the physics does not depend on the numbering;
    JAX's `test_block_loss_invariant_under_hilbert_ordering`)."""
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train_block import (
        init_train_state_block, make_train_step_block)
    from gen_fvgn_tpu.meshes.synthetic import (
        cavity_quad_mesh as jmesh, synthetic_case as jcase)
    kw = dict(batch_size=2, dataset_size=2, mxu_dtype="float32",
              hidden_size=32, message_passing_num=1, slice_num=8,
              attn_heads=4)
    losses = {}
    for method in ("rcm", "hilbert"):
        monkeypatch.setenv("GFVGN_ORDERING", method)
        pool = EnvPool([], Config(**kw), seed=0, device="cpu",
                       cases=[synthetic_case(cavity_quad_mesh(6), **CASE_KW)])
        jpool = JPool([], JConfig(**kw), seed=0, engine="block",
                      cases=[jcase(jmesh(6), **CASE_KW)])
        for key in ("node|pos", "cells_node", "face|face_node"):
            np.testing.assert_array_equal(
                pool.cases[0]["mesh"][key], jpool.cases[0]["mesh"][key])
        state, sim = init_train_state_block(pool.cfg, seed=0, device="cpu")
        step = make_train_step_block(pool.cfg, sim, device="cpu")
        _, m, _ = step(state, pool.gather_block(np.arange(2)),
                       pool.statics[0])
        losses[method] = float(m.loss)
    np.testing.assert_allclose(losses["rcm"], losses["hilbert"], rtol=2e-4)
