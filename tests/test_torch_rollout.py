"""PyTorch port, the slice as a whole: 3 steps of `rollout_block` on both
sides from the same dyn, weights and normalizer state.

float32 on float32-stored operators: per-step losses rtol 1e-3, uvp_node
atol 1e-4 on real nodes (the stated bounds; measured: losses 2e-6, uvp 9e-7
after 3 steps).

On the default statics the structural operators are stored bf16 and round
their operand to bf16 even in the float32 configuration. A last-bit float32
difference between the frameworks then flips one such rounding now and then
(a 2^-9 relative jump of one hidden element) and the rollout carries it on.
Measured over four random states: step 1 agrees to 1e-5 (max), after 3
steps the gap on uvp_node is 2e-7 to 4e-5 (median) and 1e-4 to 4e-4 (max),
the losses within 1e-3 — and the JAX package moves by as much (2e-5 to
1e-3) when its own input is perturbed by 1e-6. So on those statics the test
bounds step 1 tightly and the later steps loosely."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, f32_operator_statics,
                               jax_kernels_on, jax_norm_state,
                               numpy_norm_stats, numpy_params, random_state,
                               torch_norm_state, torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

LOSSES = ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press")
ARGS = (6, 32, 2, "float32", 2)


def _rollouts(f32_ops, n_steps=3, mxu_args=ARGS, seed=30):
    from gen_fvgn_tpu.solve.rollout_block import rollout_block as jroll
    from gen_fvgn_tpu_torch.solve.rollout_block import rollout_block as troll
    (jc, _, js, jd), (tc, _, ts, td) = both_sides(*mxu_args)
    if f32_ops:
        js, ts = f32_operator_statics(*mxu_args)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd2, td2 = random_state(jd, td, np.asarray(js.node_mask), seed=seed)
    jh = jroll(jc, jax.tree_util.tree_map(jnp.asarray, tree),
               jax_norm_state(stats), apply_fn, jd2, js, n_steps)
    th = troll(tc, torch_simulator(tc, tree), torch_norm_state(stats), td2,
               ts, n_steps)
    return jh, th, np.asarray(js.node_mask)


def test_rollout_three_steps_matches_jax_f32():
    jh, th, real = _rollouts(f32_ops=True)
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
    # the rollout really moves the state
    assert np.abs(th[2]["uvp_node"] - th[0]["uvp_node"]).max() > 1e-3


def test_rollout_three_steps_default_statics_f32():
    jh, th, real = _rollouts(f32_ops=False)
    for a, b in zip(jh, th):
        gap = np.abs(b["uvp_node"][:, real] - a["uvp_node"][:, real])
        if a["step"] == 0:
            assert gap.max() < 1e-3
        assert np.median(gap) < 5e-4
        assert gap.max() < 2e-2
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-2)


def test_rollout_three_steps_matches_jax_bf16():
    """bf16 stream at hidden 128, the JAX side on its Pallas kernels in
    interpret mode. Per-step states agree to a few bf16 roundings of the
    backbone output (scale 1: 2^-8 = 0.004 each), carried over 3 steps:
    measured max gap 0.0094, median 1e-3, losses within 2e-2."""
    with jax_kernels_on():
        jh, th, real = _rollouts(f32_ops=False,
                                 mxu_args=(6, 128, 2, "bfloat16", 2))
    for a, b in zip(jh, th):
        gap = np.abs(b["uvp_node"][:, real] - a["uvp_node"][:, real])
        assert gap.max() < 0.1 and np.median(gap) < 5e-3
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=0.1)


def _torch_setup(batch, microbatch):
    (jc, _, js, jd), (tc, _, ts, td) = both_sides(6, 32, 1, "float32", batch)
    tree, _ = numpy_params(jc, js, jd)
    tc = tc.replace(microbatch=microbatch)
    return tc, torch_simulator(tc, tree), torch_norm_state(
        numpy_norm_stats()), td, ts


def test_microbatch_chunks_equal_the_whole_batch():
    """Batch 3 at microbatch 2 (one padded chunk) equals the unchunked
    step: samples are independent."""
    from gen_fvgn_tpu_torch.solve.rollout_block import make_eval_step_block
    tc, sim, ns, td, ts = _torch_setup(3, 2)
    rng = np.random.default_rng(31)
    td = td.replace(uvp=td.uvp + torch.from_numpy(
        0.1 * rng.normal(size=tuple(td.uvp.shape)).astype(np.float32))
        * ts.node_mask[None, :, None])
    chunked = make_eval_step_block(tc, sim)(ns, td, ts)
    whole = make_eval_step_block(tc.replace(microbatch=0), sim)(ns, td, ts)
    for f in LOSSES + ("uvp_node_new", "uvp_cell_new"):
        a, b = getattr(chunked, f), getattr(whole, f)
        assert a.shape == b.shape and a.shape[0] == 3
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_rollout_scan_equals_rollout_and_callbacks_run():
    from gen_fvgn_tpu_torch.solve.rollout_block import (rollout_block,
                                                        rollout_block_scan)
    tc, sim, ns, td, ts = _torch_setup(2, 8)
    seen = []
    hist = rollout_block(tc, sim, ns, td, ts, 2,
                         export_fn=lambda t, un, uc, rec: seen.append(t))
    final, traces = rollout_block_scan(tc, sim, ns, td, ts, 2)
    assert seen == [0, 1] and len(traces) == 4
    assert tuple(traces[0].shape) == (2, 2, 1)
    np.testing.assert_array_equal(final.uvp.numpy(), hist[-1]["uvp_node"])
    np.testing.assert_array_equal(traces[0][:, :, 0].numpy(),
                                  np.stack([h["loss_cont"] for h in hist]))
    # a pressure source is added to p before each step
    n_pad = td.uvp.shape[1]
    src = lambda t: np.full((2, n_pad), 0.25 * t, np.float32)
    with_src = rollout_block(tc, sim, ns, td, ts, 1, wave_source_fn=src)
    shifted = rollout_block(tc, sim, ns, td.replace(
        uvp=td.uvp + torch.tensor([0.0, 0.0, 0.25])), ts, 1)
    np.testing.assert_array_equal(with_src[0]["uvp_node"],
                                  shifted[0]["uvp_node"])


def test_plain_kernels_argument_gives_the_same_step_on_cpu():
    """On the CPU the kernel wrappers already take their plain versions, so
    the step inside `ops.plain_versions()` (the one switch to them) is the
    same step."""
    from gen_fvgn_tpu_torch.ops import plain_versions
    from gen_fvgn_tpu_torch.solve.rollout_block import make_eval_step_block
    (jc, _, js, jd), (tc, _, ts, td) = both_sides(6, 128, 1, "bfloat16", 2)
    tree, _ = numpy_params(jc, js, jd)
    sim = torch_simulator(tc, tree)
    ns = torch_norm_state(numpy_norm_stats())
    a = make_eval_step_block(tc, sim)(ns, td, ts)
    with plain_versions():
        b = make_eval_step_block(tc, sim)(ns, td, ts)
    assert torch.equal(a.uvp_node_new, b.uvp_node_new)
    assert torch.equal(a.loss_cont, b.loss_cont)
