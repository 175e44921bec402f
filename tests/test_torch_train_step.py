"""PyTorch port, one training step's loss and gradients against
`jax.value_and_grad` of the JAX package's loss (`forward_batch_block` with
normalizer accumulation, then `training_loss`) on the same small synthetic
cavity, NumPy weights, normalizer statistics and state.

float32 (hidden 32, structural operators stored float32 on both sides, see
torch_port_common.f32_operator_statics): the loss within 1e-6 relative,
the global gradient norm within 1e-4 relative, the difference of the whole
gradient within 1e-4 of its norm, and each parameter's gradient within
1e-3 of its own norm. Measured: TransFVGN_v2 5e-6 of the norm (worst
tensor 4e-5), FVGN 7e-7.

bfloat16 (hidden 128, every kernel's dispatch on; the JAX side on its
Pallas kernels in interpret mode, the port on its kernels' plain versions):
the bound is tied to the JAX net's own sensitivity. Moving ONE element of
the input state by 1e-3 moves the JAX gradient by s (measured s = 0.0061
of its norm, mostly in the second Transolver block's slice projections:
the bf16 net flips roundings wherever its input moves). The port's
gradient must lie within 2·s of the JAX gradient (measured 0.0081, ratio
1.3), its norm within 2·s, every tensor's cosine with the JAX tensor at
least 0.9, and the loss within 1e-3 relative (measured 2.6e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, f32_operator_statics, jax_flat,
                               jax_kernels_on, jax_norm_state,
                               numpy_norm_stats, numpy_params, port_flat,
                               random_state, torch_norm_state,
                               torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

F32 = (6, 32, 1, "float32", 2)
BF16 = (6, 128, 1, "bfloat16", 2)


def port_grads(sim, loss):
    """{flax path: float64 NumPy} of d loss / d parameter (zeros where a
    parameter takes no part)."""
    named = list(sim.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return port_flat({n: torch.zeros_like(p) if g is None else g
                      for (n, p), g in zip(named, grads)})


def rel_gap(a, b):
    """‖a − b‖ / ‖b‖ over all tensors of two {path: array} dicts."""
    num = sum(((a[k] - b[k]) ** 2).sum() for k in b)
    return float(np.sqrt(num / sum((v ** 2).sum() for v in b.values())))


def global_norm(g):
    return float(np.sqrt(sum((v ** 2).sum() for v in g.values())))


def setup(net, args, seed=5):
    (jc, _, js, jd), (tc, _, ts, td) = both_sides(*args, net=net)
    if args[3] == "float32":
        js, ts = f32_operator_statics(*args, net=net)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd2, td2 = random_state(jd, td, np.asarray(js.node_mask), seed=seed)
    return jc, tc, js, ts, jd2, td2, tree, apply_fn, stats


def jax_value_and_grad(jc, js, jd, apply_fn, stats):
    """jit(value_and_grad) of the JAX training loss over (params, uvp)."""
    from gen_fvgn_tpu.training.forward import training_loss
    from gen_fvgn_tpu.training.forward_block import forward_batch_block

    def loss_fn(params, uvp):
        out = forward_batch_block(apply_fn, params, jax_norm_state(stats),
                                  jd.replace(uvp=uvp), js, jc,
                                  accumulate_normalizer=True)
        return training_loss(out, jc)
    return jax.jit(jax.value_and_grad(loss_fn))


def port_loss(tc, ts, td, sim, stats):
    from gen_fvgn_tpu_torch.training.forward import training_loss
    from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
    out = forward_batch_block(sim, torch_norm_state(stats), td, ts, tc,
                              accumulate_normalizer=True)
    return training_loss(out, tc)


@pytest.mark.parametrize("net,args", [
    pytest.param("TransFVGN_v2", F32, id="TransFVGN_v2"),
    pytest.param("FVGN", F32, id="FVGN"),
    # FVGNSimulatorB at hidden 256, the width the MLP kernels now also take
    pytest.param("FVGN", (6, 256, 1, "float32", 2), id="FVGN-h256"),
    # TransFVGN_v2 at hidden 256, the width the Transolver kernels now take
    pytest.param("TransFVGN_v2", (6, 256, 1, "float32", 2),
                 id="TransFVGN_v2-h256")])
def test_train_loss_and_grads_match_jax_f32(net, args):
    jc, tc, js, ts, jd, td, tree, apply_fn, stats = setup(net, args)
    jl, jg = jax_value_and_grad(jc, js, jd, apply_fn, stats)(
        jax.tree_util.tree_map(jnp.asarray, tree), jd.uvp)
    jg = jax_flat(jg)
    sim = torch_simulator(tc, tree)
    loss = port_loss(tc, ts, td, sim, stats)
    tg = port_grads(sim, loss)
    assert set(tg) == set(jg)
    assert all(tg[k].shape == jg[k].shape for k in jg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert abs(global_norm(tg) / global_norm(jg) - 1.0) < 1e-4
    assert rel_gap(tg, jg) < 1e-4
    scale = global_norm(jg)
    for k in jg:
        gap = np.linalg.norm(tg[k] - jg[k])
        assert gap <= 1e-3 * np.linalg.norm(jg[k]) + 1e-7 * scale, k


def test_train_grads_match_jax_bf16_within_its_own_sensitivity():
    jc, tc, js, ts, jd, td, tree, apply_fn, stats = setup("TransFVGN_v2",
                                                          BF16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    moved = np.asarray(jd.uvp).copy()
    real = np.flatnonzero(np.asarray(js.node_mask))
    moved[0, real[len(real) // 2], 0] += 1e-3
    with jax_kernels_on():
        f = jax_value_and_grad(jc, js, jd, apply_fn, stats)
        jl, jg = f(jp, jd.uvp)
        _, jg_moved = f(jp, jnp.asarray(moved))
    jg, jg_moved = jax_flat(jg), jax_flat(jg_moved)
    s = rel_gap(jg_moved, jg)
    assert s > 0.0
    sim = torch_simulator(tc, tree)
    loss = port_loss(tc, ts, td, sim, stats)
    tg = port_grads(sim, loss)
    assert set(tg) == set(jg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    gap = rel_gap(tg, jg)
    assert gap <= 2.0 * s, (gap, s)
    assert abs(global_norm(tg) / global_norm(jg) - 1.0) <= 2.0 * s
    for k in jg:
        a, b = tg[k].ravel(), jg[k].ravel()
        nb = np.linalg.norm(b)
        if nb == 0.0:
            assert not a.any(), k
            continue
        cos = float(a @ b / (np.linalg.norm(a) * nb))
        assert cos >= 0.9, (k, cos)


def test_bf16_train_step_goes_through_every_kernel_wrapper():
    """Hidden 128 in bf16, one GraphNet block a processor: one train step
    reaches each forward wrapper as the rollout does and each backward
    wrapper once per forward call, and the spmm wrapper 3 times a GraphNet
    block forward and 5 times backward (the transposes of adj, nbr_r and
    nbr_s, and of the two row gathers of the projected rows). At the
    Config default of 3 blocks a processor that is 48 spmm and 14 + 14
    fused_mlp_ln launches a step."""
    from unittest import mock

    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    from gen_fvgn_tpu_torch.ops import spmm as sp
    from gen_fvgn_tpu_torch.training.train import TrainState, make_optimizer
    from gen_fvgn_tpu_torch.training.train_block import make_train_step_block
    jc, tc, js, ts, jd, td, tree, _, stats = setup("TransFVGN_v2", BF16)
    sim = torch_simulator(tc, tree)
    state = TrainState(simulator=sim,
                       optimizer=make_optimizer(tc, sim.parameters()),
                       norm_state=torch_norm_state(stats))
    wrapped = [(sp, "spmm"), (fm, "fused_mlp_ln"), (fm, "fused_mlp_noln"),
               (fm, "fused_premlp_res"), (fsa, "fused_slice_pool_kernel"),
               (fm, "fused_mlp_ln_bwd"), (fm, "fused_mlp_noln_bwd"),
               (fm, "fused_premlp_res_bwd"),
               (fsa, "fused_slice_pool_bwd_kernel")]
    patches = [mock.patch.object(m, n, wraps=getattr(m, n))
               for m, n in wrapped]
    mocks = [p.start() for p in patches]
    try:
        state, metrics, uvp = make_train_step_block(tc, sim, device="cpu")(
            state, td, ts)
    finally:
        for p in patches:
            p.stop()
    got = {n: m.call_count for (_, n), m in zip(wrapped, mocks)}
    assert got == dict(spmm=16, fused_mlp_ln=6, fused_mlp_noln=1,
                       fused_premlp_res=2, fused_slice_pool_kernel=2,
                       fused_mlp_ln_bwd=6, fused_mlp_noln_bwd=1,
                       fused_premlp_res_bwd=2, fused_slice_pool_bwd_kernel=2)
    assert np.isfinite(float(metrics.loss)) and float(metrics.grad_norm) > 0
    assert state.step == 1 and uvp.shape == td.uvp.shape
