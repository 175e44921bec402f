"""PyTorch port, the backbone: `Mlp`, `GnBlockB` and `FVGNSimulatorB` with
converted weights against their flax counterparts on the same NumPy inputs.

float32 (`mxu_dtype="float32"`, hidden 32): rtol 1e-4 of the output scale,
on statics whose structural operators are stored float32 on both sides (see
torch_port_common.f32_operator_statics: with the default bf16-stored
operators a last-bit difference can flip an operand's bf16 rounding).

bfloat16 (hidden 128, the widths where both fused dispatches fire) with
the JAX side's Pallas kernels on (torch_port_common.jax_kernels_on), in
interpret mode. Measured gap of the simulator's output:
one bf16 ulp of the output scale (0.0156 at scale 2), median 6e-4; the
tolerance is 4 ulps, and 3 ulps for one block."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, f32_operator_statics,
                               jax_kernels_on, numpy_params, to_plain_dict,
                               torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)


def _inputs(tstatic, seed, batch=2, h=None):
    rng = np.random.default_rng(seed)
    n, e = tstatic.pos.shape[0], tstatic.edge_pos_feat.shape[0]
    wn, we = (12, 15) if h is None else (h, h)
    return (rng.normal(size=(batch, n, wn)).astype(np.float32),
            rng.normal(size=(batch, e, we)).astype(np.float32))


def _ulps(ref, n):
    scale = float(np.abs(ref).max())
    return n * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _setup(mxu, hidden=None):
    if mxu == "float32":
        args = (6, hidden or 32, 1, "float32", 2)
        (jc, _, _, jd), (tc, _, _, _) = both_sides(*args)
        js, ts = f32_operator_statics(*args)
    else:
        (jc, _, js, jd), (tc, _, ts, _) = both_sides(6, 128, 1, "bfloat16", 2)
    tree, apply_fn = numpy_params(jc, js, jd)
    return jc, tc, js, ts, tree, apply_fn


@pytest.mark.parametrize("which", ["node_encoder", "edge_encoder",
                                   "node_decoder"])
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_mlp_matches_flax(mxu, which):
    from gen_fvgn_tpu.models.mlp import Mlp as JMlp
    jc, tc, js, ts, tree, _ = _setup(mxu)
    sim = torch_simulator(tc, tree)
    h = jc.hidden_size
    jdt = jnp.bfloat16 if mxu == "bfloat16" else None
    if which == "node_decoder":
        sub, tm = tree["params"]["decoder"][which], sim.decoder.node_decoder
        jm = JMlp(h, 3, layer_norm=False, dtype=jdt)
        width = h
    else:
        sub, tm = tree["params"]["encoder"][which], getattr(sim.encoder, which)
        jm = JMlp(h, h, dtype=jdt)
        width = 12 if which == "node_encoder" else 15
    x = np.random.default_rng(11).normal(size=(2, 200, width)).astype(
        np.float32)
    with jax_kernels_on():
        ref = np.asarray(jm.apply({"params": sub}, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    if mxu == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=_ulps(ref, 2))


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_gn_block_matches_flax(mxu):
    _gn_block_against_flax(mxu)


def _gn_block_against_flax(mxu, jax_composed_gather=False):
    """The port's GnBlockB (take path) against JAX's, the JAX switch
    `use_composed_gather` pinned to `jax_composed_gather`."""
    from gen_fvgn_tpu.models.gn_block import GnBlockB as JGn
    jc, tc, js, ts, tree, _ = _setup(mxu)
    sim = torch_simulator(tc, tree)
    h = jc.hidden_size
    jdt = jnp.bfloat16 if mxu == "bfloat16" else None
    node, edge = _inputs(ts, 12, h=h)
    jgn = JGn(h, jdt, "composed")
    sub = tree["params"]["gn_0"]
    cast = (lambda a: jnp.asarray(a, jdt)) if jdt else jnp.asarray
    with jax_kernels_on(composed_gather=jax_composed_gather):
        jn, je = jax.vmap(lambda a, b: jgn.apply({"params": sub}, a, b, js))(
            cast(node), cast(edge))
    tdt = torch.bfloat16 if mxu == "bfloat16" else torch.float32
    with torch.no_grad():
        tn, te = sim.gn_0(torch.from_numpy(node).to(tdt),
                          torch.from_numpy(edge).to(tdt), ts)
    real_n = ts.node_mask.numpy()
    # every edge row, the padded ones too: their gathered projections
    # carry row 0's data in both packages
    real_e = slice(None)
    for ref, got, rows in ((jn, tn, real_n), (je, te, real_e)):
        ref = np.asarray(ref, np.float32)[:, rows]
        got = got.float().numpy()[:, rows]
        assert got.dtype == np.float32 and got.shape == ref.shape
        if mxu == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max())
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=_ulps(ref, 3))
    assert tn.dtype == tdt and te.dtype == tdt


@pytest.mark.parametrize("mxu,hidden", [
    pytest.param("float32", None, id="float32"),
    pytest.param("bfloat16", None, id="bfloat16"),
    # hidden 256: the width the MLP kernels now also take (FVGN's node MLP
    # parts 128 + 256)
    pytest.param("float32", 256, id="float32-h256")])
def test_simulator_matches_flax(mxu, hidden):
    jc, tc, js, ts, tree, apply_fn = _setup(mxu, hidden)
    sim = torch_simulator(tc, tree)
    node, edge = _inputs(ts, 13)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax_kernels_on():
        ref = np.asarray(jax.vmap(lambda a, b: apply_fn(jt, a, b, js))(
            jnp.asarray(node), jnp.asarray(edge)), np.float32)
    with torch.no_grad():
        out = sim(torch.from_numpy(node), torch.from_numpy(edge), ts)
    real = ts.node_mask.numpy()
    got = out.float().numpy()
    assert got.shape == ref.shape == (2, ts.pos.shape[0], 3)
    if mxu == "float32":
        assert out.dtype == torch.float32
        np.testing.assert_allclose(got[:, real], ref[:, real], rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    else:
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(got[:, real], ref[:, real], rtol=0,
                                   atol=_ulps(ref, 4))
        assert np.median(np.abs(got - ref)[:, real]) < 2e-3


def test_bf16_simulator_goes_through_the_fused_and_spmm_dispatch():
    """At hidden 128 in bf16 one simulator call reaches the spmm wrapper 3
    times a block, fused_mlp_ln 2 + 2 a block times and fused_mlp_noln
    once — the per-step launch counts of the card."""
    from unittest import mock

    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import spmm as sp
    jc, tc, js, ts, tree, _ = _setup("bfloat16")
    sim = torch_simulator(tc, tree)
    node, edge = _inputs(ts, 14)
    with mock.patch.object(sp, "spmm", wraps=sp.spmm) as m_sp, \
            mock.patch.object(fm, "fused_mlp_ln", wraps=fm.fused_mlp_ln) \
            as m_ln, \
            mock.patch.object(fm, "fused_mlp_noln", wraps=fm.fused_mlp_noln) \
            as m_no, torch.no_grad():
        sim(torch.from_numpy(node), torch.from_numpy(edge), ts)
    n_blocks = tc.message_passing_num
    assert m_sp.call_count == 3 * n_blocks
    assert m_ln.call_count == 2 + 2 * n_blocks
    assert m_no.call_count == 1


def test_f32_simulator_uses_no_fused_dispatch():
    from unittest import mock

    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    jc, tc, js, ts, tree, _ = _setup("float32")
    sim = torch_simulator(tc, tree)
    node, edge = _inputs(ts, 15)
    with mock.patch.object(fm, "fused_mlp_ln_parts") as m_ln, \
            mock.patch.object(fm, "fused_mlp_noln_parts") as m_no, \
            torch.no_grad():
        sim(torch.from_numpy(node), torch.from_numpy(edge), ts)
    assert m_ln.call_count == 0 and m_no.call_count == 0


def test_init_is_truncated_normal_and_seeded():
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    cfg = Config(net="FVGN", hidden_size=32, message_passing_num=1)
    a = make_simulator_block(cfg, device="cpu", seed=0).state_dict()
    b = make_simulator_block(cfg, device="cpu", seed=0).state_dict()
    c = make_simulator_block(cfg, device="cpu", seed=1).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k])
        if k.endswith("kernel"):
            assert a[k].abs().max() <= 0.04 and 0.01 < a[k].std() < 0.03
            assert not torch.equal(a[k], c[k])
        elif k.endswith("scale"):
            assert (a[k] == 1).all()
        else:
            assert (a[k] == 0).all()


def test_state_dict_keys_are_the_flax_paths():
    jc, tc, js, ts, tree, _ = _setup("float32")
    from gen_fvgn_tpu_torch.convert import params_from_flax
    sd = params_from_flax(to_plain_dict(tree))
    sim = torch_simulator(tc, tree)
    assert set(sd) == set(sim.state_dict())
    assert "encoder.node_encoder.hidden_0.kernel" in sd
    assert "gn_0.edge_block.edge_mlp.ln.scale" in sd
    assert tuple(sd["gn_0.node_block.node_mlp.hidden_0.kernel"].shape) == \
        (jc.hidden_size // 2 + jc.hidden_size, jc.hidden_size)


def test_jax_composed_gather_left_on_does_not_reach_the_port_tests(request):
    """tests/test_block_engine.py::test_composed_gather_matches_take_path
    leaves the JAX switch `use_composed_gather` on for the rest of its
    process. Taken, that form zeroes the padded edge rows that the port's
    take path fills with row 0's data, and the comparison of
    test_gn_block_matches_flax[bfloat16] fails. With the switch left on,
    that test still passes: its JAX calls go through `jax_kernels_on`,
    which pins the form under test, and every test of this file runs under
    the autouse fixture `pin_jax_block_forms`; both restore the switch."""
    from gen_fvgn_tpu.models import gn_block as jgb
    assert "pin_jax_block_forms" in request.fixturenames
    assert jgb._COMPOSED_GATHER is False
    saved = jgb._COMPOSED_GATHER
    jgb.use_composed_gather(True)         # as the JAX test leaves it
    try:
        test_gn_block_matches_flax("bfloat16")
        assert jgb._COMPOSED_GATHER is True
        with pytest.raises(AssertionError):
            _gn_block_against_flax("bfloat16", jax_composed_gather=True)
    finally:
        jgb.use_composed_gather(saved)
