"""PyTorch port, the Transolver nets: `TransFVGNv1B` and `TransFVGNv2B` with
converted weights against their flax counterparts, and 3 steps of a
`TransFVGN_v2` rollout on both sides from the same dyn, weights and
normalizer state.

float32 (hidden 32, plain-layer forms) on statics whose structural
operators are stored float32 on both sides (torch_port_common.
f32_operator_statics): the nets' outputs within 1e-4 of their scale; the
rollout's losses rtol 1e-3 and uvp_node atol 1e-4 on real nodes
(measured: uvp_node 1e-5, losses 3e-6 after 3 steps).

bfloat16 (hidden 128, the widths where every kernel's dispatch fires; the
JAX side on its Pallas kernels in interpret mode, the port on its kernels'
plain versions): the nets' outputs within 4 bf16 ulps of the output scale
and a median within 1. Measured: v1 max 0.0088, median 0.001 at scale 2;
v2 max 0.19, median 0.031 at scale 13.6. v2's gap is the propagation of
the few one-ulp differences of its first GraphNet blocks through the
second Transolver block, whose tokens pool every node: given the JAX
side's own input, that block agrees to 1 element in 2,500 (0.002 at scale
20), and the JAX v2 net itself moves by 0.34 (max) when one input element
moves by 1e-2. The rollout loosely, as for the FVGN net
(tests/test_torch_rollout.py): a few bf16 roundings of the backbone
output, carried over 3 steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, f32_operator_statics,
                               jax_kernels_on, jax_norm_state,
                               numpy_norm_stats, numpy_params, random_state,
                               torch_norm_state, torch_simulator)

LOSSES = ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press")
F32 = (6, 32, 1, "float32", 2)
BF16 = (6, 128, 1, "bfloat16", 2)


def _ulps(ref, n):
    scale = float(np.abs(ref).max())
    return n * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _setup(net, args):
    (jc, _, js, jd), (tc, _, ts, td) = both_sides(*args, net=net)
    if args[3] == "float32":
        js, ts = f32_operator_statics(*args, net=net)
    tree, apply_fn = numpy_params(jc, js, jd)
    return jc, tc, js, ts, jd, td, tree, apply_fn


BF16_H256 = (6, 256, 1, "bfloat16", 2)


@pytest.mark.parametrize("net,mxu,args", [
    pytest.param(net, mxu, F32 if mxu == "float32" else BF16,
                 id=f"{net}-{mxu}")
    for net in ("TransFVGN_v1", "TransFVGN_v2")
    for mxu in ("float32", "bfloat16")] + [
    # hidden 256: the Transolver kernels' forms at C = 256 (K5 hidden 512,
    # K6 8 heads of 32) on both sides
    pytest.param("TransFVGN_v2", "bfloat16", BF16_H256,
                 id="TransFVGN_v2-bfloat16-h256")])
def test_transfvgn_matches_flax(net, mxu, args):
    jc, tc, js, ts, _, _, tree, apply_fn = _setup(net, args)
    sim = torch_simulator(tc, tree)
    rng = np.random.default_rng(40)
    n, e = ts.pos.shape[0], ts.edge_pos_feat.shape[0]
    node = rng.normal(size=(2, n, 12)).astype(np.float32)
    edge = rng.normal(size=(2, e, 15)).astype(np.float32)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax_kernels_on():
        ref = np.asarray(jax.vmap(lambda a, b: apply_fn(jt, a, b, js))(
            jnp.asarray(node), jnp.asarray(edge)), np.float32)
    with torch.no_grad():
        out = sim(torch.from_numpy(node), torch.from_numpy(edge), ts)
    real = ts.node_mask.numpy()
    got = out.float().numpy()
    assert got.shape == ref.shape == (2, n, 3)
    if mxu == "float32":
        assert out.dtype == torch.float32
        np.testing.assert_allclose(got[:, real], ref[:, real], rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    else:
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(got[:, real], ref[:, real], rtol=0,
                                   atol=_ulps(ref, 4))
        assert np.median(np.abs(got - ref)[:, real]) <= _ulps(ref, 1)


@pytest.mark.parametrize("net,per_step", [
    ("TransFVGN_v2", dict(spmm=6, ln=6, noln=1, premlp=2, pool=2)),
    ("TransFVGN_v1", dict(spmm=3, ln=4, noln=1, premlp=1, pool=1))])
def test_bf16_transfvgn_goes_through_every_kernel_wrapper(net, per_step):
    """Hidden 128 in bf16, one GraphNet block a processor: one simulator
    call reaches the spmm wrapper 3 times a GraphNet block, fused_mlp_ln
    2 + 2 a block, fused_mlp_noln once and fused_premlp_res /
    fused_slice_pool once a Transolver block. (At the Config default of 3
    blocks a processor, v2 makes 18 / 14 / 1 / 2 / 2 launches a step.)"""
    from unittest import mock

    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    from gen_fvgn_tpu_torch.ops import spmm as sp
    jc, tc, js, ts, _, _, tree, _ = _setup(net, BF16)
    sim = torch_simulator(tc, tree)
    rng = np.random.default_rng(41)
    n, e = ts.pos.shape[0], ts.edge_pos_feat.shape[0]
    node = torch.from_numpy(rng.normal(size=(2, n, 12)).astype(np.float32))
    edge = torch.from_numpy(rng.normal(size=(2, e, 15)).astype(np.float32))
    wrap = lambda mod, name: mock.patch.object(
        mod, name, wraps=getattr(mod, name))
    with wrap(sp, "spmm") as m_sp, wrap(fm, "fused_mlp_ln") as m_ln, \
            wrap(fm, "fused_mlp_noln") as m_no, \
            wrap(fm, "fused_premlp_res") as m_pre, \
            wrap(fsa, "fused_slice_pool_kernel") as m_pool, torch.no_grad():
        sim(node, edge, ts)
    got = dict(spmm=m_sp.call_count, ln=m_ln.call_count,
               noln=m_no.call_count, premlp=m_pre.call_count,
               pool=m_pool.call_count)
    assert got == per_step


def _rollouts(args, n_steps=3, seed=42):
    from gen_fvgn_tpu.solve.rollout_block import rollout_block as jroll
    from gen_fvgn_tpu_torch.solve.rollout_block import rollout_block as troll
    jc, tc, js, ts, jd, td, tree, apply_fn = _setup("TransFVGN_v2", args)
    stats = numpy_norm_stats()
    jd2, td2 = random_state(jd, td, np.asarray(js.node_mask), seed=seed)
    jh = jroll(jc, jax.tree_util.tree_map(jnp.asarray, tree),
               jax_norm_state(stats), apply_fn, jd2, js, n_steps)
    th = troll(tc, torch_simulator(tc, tree), torch_norm_state(stats), td2,
               ts, n_steps)
    return jh, th, np.asarray(js.node_mask)


def test_transfvgn_v2_rollout_three_steps_matches_jax_f32():
    jh, th, real = _rollouts(F32)
    assert len(jh) == len(th) == 3
    for a, b in zip(jh, th):
        assert a["step"] == b["step"]
        for k in LOSSES:
            assert b[k].shape == a[k].shape == (2,)
            np.testing.assert_allclose(b[k], a[k], rtol=1e-3)
        np.testing.assert_allclose(b["uvp_node"][:, real],
                                   a["uvp_node"][:, real], atol=1e-4)
        np.testing.assert_allclose(b["uvp_cell"], a["uvp_cell"], atol=1e-4)
        assert np.isfinite(b["uvp_node"]).all()
    assert np.abs(th[2]["uvp_node"] - th[0]["uvp_node"]).max() > 1e-3


def test_transfvgn_v2_rollout_three_steps_matches_jax_bf16():
    """Measured: uvp_node max gap 0.031, 0.035, 0.060 and median 0.0043,
    0.0060, 0.0074 over the 3 steps (state scale 3: one bf16 rounding is
    0.012 there); losses within 6e-2."""
    with jax_kernels_on():
        jh, th, real = _rollouts(BF16)
    for a, b in zip(jh, th):
        gap = np.abs(b["uvp_node"][:, real] - a["uvp_node"][:, real])
        assert gap.max() < 0.1 and np.median(gap) < 1e-2
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=0.1)
