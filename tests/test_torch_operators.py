"""PyTorch port, host statics: the compiled mesh, the WLSQ statics and every
operator of build_mesh_operators against the JAX package on the same small
cavity. Operators are compared as dense matrices (an identity probe through
the JAX apply_linop), float32, rtol 1e-5: the two packages may order the
extra stencil pairs differently, so stencils are not compared entry by
entry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import both_sides

LINOPS = ["adj", "gather_s", "gather_r", "edge_diff", "scat_r", "scat_s",
          "nbr_r", "nbr_s", "wlsq", "n2c_m0", "n2c_mx", "n2c_my", "n2f_m0",
          "n2f_mx", "n2f_my", "c2n", "flux_x", "flux_y"]
ARRAYS = ["deg", "face_inflow", "face_wall", "s_out"]


def _dense_of_jax(op, n_in, direction="fwd"):
    """Dense matrix of a JAX LinOp direction via an identity probe narrower
    than 256 bytes a row, so take-indexed operators go through their tiles
    and padded rows come out zero."""
    from gen_fvgn_tpu.ops.blocksparse import _apply_block_op
    blk = getattr(op, direction)
    cols = []
    for c0 in range(0, n_in, 32):       # 32 f32 columns = 128 bytes a row
        probe = np.zeros((n_in, 32), np.float32)
        for j in range(32):
            if c0 + j < n_in:
                probe[c0 + j, j] = 1.0
        cols.append(np.asarray(_apply_block_op(blk, jnp.asarray(probe)),
                               np.float32))
    return np.concatenate(cols, axis=1)[:, :n_in]


@pytest.mark.parametrize("name", LINOPS)
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_operator_dense_matches_jax(name, direction):
    (_, _, jstatic, _), (_, _, tstatic, _) = both_sides()
    top = getattr(getattr(tstatic.ops, name), direction)
    jop = getattr(jstatic.ops, name)
    ref = _dense_of_jax(jop, top.n_in, direction)
    got = top.to_dense().numpy()
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    # structure: the same non-zero pattern up to entries at rounding level
    assert ((np.abs(ref) > 1e-4 * scale) <= (got != 0)).all()


def test_full_row_wlsq_operator_matches_jax():
    """wlsq_rows="full" folds all k=5 derivative rows of the 2nd-order
    solve, not only the two gradient rows."""
    from gen_fvgn_tpu.graph.operators import build_mesh_operators as jbuild
    from gen_fvgn_tpu_torch.graph.operators import \
        build_mesh_operators as tbuild
    (jc, jp, _, _), (tc, tp, _, _) = both_sides()
    jops = jbuild(jp.cases[0]["mesh"], jc.order, jp.case_sizes[0], 256,
                  wlsq_rows="full")
    tops = tbuild(tp.cases[0]["mesh"], tc.order, tp.case_sizes[0], 256,
                  wlsq_rows="full")
    assert tops.wlsq_n_q == jops.wlsq_n_q == 5 and tops.nbr_r is None
    ref = _dense_of_jax(jops.wlsq, tops.wlsq.fwd.n_in)
    got = tops.wlsq.fwd.to_dense().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ARRAYS)
def test_static_arrays_match_jax(name):
    (_, _, jstatic, _), (_, _, tstatic, _) = both_sides()
    np.testing.assert_array_equal(
        getattr(tstatic.ops, name).numpy(),
        np.asarray(getattr(jstatic.ops, name)))


@pytest.mark.parametrize("name", ["pos", "node_type", "node_mask",
                                  "cells_area", "edge_pos_feat"])
def test_static_pack_fields_match_jax(name):
    (_, _, jstatic, _), (_, _, tstatic, _) = both_sides()
    np.testing.assert_array_equal(getattr(tstatic, name).numpy(),
                                  np.asarray(getattr(jstatic, name)))


@pytest.mark.parametrize("name", ["uvp", "target_uv", "theta", "sigma",
                                  "uvp_dim", "dt"])
def test_dynamic_pack_fields_match_jax(name):
    (_, _, _, jdyn), (_, _, _, tdyn) = both_sides()
    np.testing.assert_array_equal(getattr(tdyn, name).numpy(),
                                  np.asarray(getattr(jdyn, name)))


@pytest.mark.parametrize("key", ["node|pos", "node|node_type", "cells_node",
                                 "cells_index", "cells_face",
                                 "face|face_node", "face|face_type",
                                 "face|neighbour_cell", "cell|cells_area",
                                 "unit_norm_v", "face_node_x"])
def test_compiled_rcm_mesh_matches_jax(key):
    (_, jpool, _, _), (_, tpool, _, _) = both_sides()
    np.testing.assert_array_equal(tpool.cases[0]["mesh"][key],
                                  jpool.cases[0]["mesh"][key])


def test_stencil_same_pairs_with_multiplicity():
    (_, jpool, _, _), (_, tpool, _, _) = both_sides()
    js = jpool.cases[0]["mesh"]["stencil"]
    ts = tpool.cases[0]["mesh"]["stencil"]
    assert js.shape == ts.shape
    key = lambda s: np.sort(s[0].astype(np.int64) * 10 ** 6 + s[1])
    np.testing.assert_array_equal(key(ts), key(js))


@pytest.mark.parametrize("order", ["1st", "2nd", "3rd"])
def test_wlsq_moments_and_fold_match_jax(order):
    from gen_fvgn_tpu.ops.wlsq import wlsq_moments as jmom
    from gen_fvgn_tpu.ops.wlsq import wlsq_solve_matrix as jfold
    from gen_fvgn_tpu_torch.ops.wlsq import wlsq_moments, wlsq_solve_matrix
    (_, jpool, _, _), _ = both_sides()
    mesh = jpool.cases[0]["mesh"]
    pos = mesh["node|pos"].astype(np.float32)
    stencil = mesh["stencil"].astype(np.int32)
    ja, jb, jc = (np.asarray(v) for v in jmom(jnp.asarray(pos),
                                              jnp.asarray(stencil), order))
    ta, tb, tc = wlsq_moments(pos, stencil, order)
    for got, ref in ((ta, ja), (tb, jb), (tc, jc)):
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    # the float64 fold of the SAME moments is the same function
    np.testing.assert_array_equal(wlsq_solve_matrix(ja, jc, order=order),
                                  jfold(ja, jc, order=order))


def test_padded_rows_are_empty_and_take_rows_index_zero():
    _, (_, tpool, tstatic, _) = both_sides()
    n_real = tpool.cases[0]["mesh"]["node|pos"].shape[0]
    e_real = tpool.cases[0]["mesh"]["face|face_node"].shape[1]
    for name, real in (("adj", n_real), ("nbr_r", n_real), ("nbr_s", n_real),
                       ("edge_diff", e_real), ("gather_s", e_real)):
        crow = getattr(tstatic.ops, name).fwd.crow.numpy()
        assert (np.diff(crow)[real:] == 0).all(), name
    assert (tstatic.ops.gather_s.fwd.take_idx.numpy()[e_real:] == 0).all()
    assert tstatic.ops.adj.fwd.dtype == torch.bfloat16
    assert tstatic.ops.wlsq.fwd.dtype == torch.float32
