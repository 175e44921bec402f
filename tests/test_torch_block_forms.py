"""PyTorch port, the block engine's other forms against the JAX package on
the same small synthetic cavity, NumPy weights and inputs: the NodeBlock
aggregations `node_agg="split"` and `"wide"`, the EdgeBlock's composed
gathers (`edge_gather="composed"`; the JAX side under its process-wide
`use_composed_gather(True)`, restored on exit), the per-sample FV residual
(`fv_packed=False`) and the ELL form of the packed one (`fv_ell=True`); the
port runs its packed CSR products for both FV forms.

The JAX statics are built with node_agg "composed" (the JAX package builds
its composed gathers only then) and serve every JAX form; the port's are
built with the form's own Config fields.

Limits, each beside the value measured when it was set:
  * float32 (structural operators stored float32 on both sides, hidden
    128 for the GraphNet block and its net so that K1's dispatch width is
    met, 32 for the train steps): outputs within 1e-5 of their scale
    (measured 2.3e-7 to 1.3e-6); a train step's loss within 1e-5 relative
    (measured 0: the same bits), its gradient within 1e-5 of its norm
    (measured 7.3e-7 to 8.9e-7) and each tensor within 1e-3 of its own
    norm (2.8e-6); the FV forms' losses and states within 1e-5 of their
    scale of JAX's (measured 1.1e-6) and of the port's default form (the
    same bits: the same products).
  * bfloat16 (hidden 128, the JAX side's Pallas kernels in interpret
    mode): a GraphNet block within 3 bf16 ulps of the output scale and
    the net within 4 (measured 1 ulp: 0.0054 of the scale), as in
    tests/test_torch_models.py; a train step's gradient within twice the
    JAX gradient's own move under a 1e-3 change of one input, the loss
    within 1e-3 relative, as in tests/test_torch_train_step.py.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, jax_block_forms, jax_flat,
                               jax_kernels_on, jax_norm_state,
                               numpy_norm_stats, numpy_params, port_flat,
                               random_state, torch_norm_state,
                               torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

# form -> the Config fields that select it
FORMS = {
    "split": dict(node_agg="split"),
    "wide": dict(node_agg="wide"),
    "composed_gather": dict(edge_gather="composed"),
    "fv_per_sample": dict(fv_packed=False),
    "fv_ell": dict(fv_ell=True),
}
MODEL_FORMS = ("split", "wide", "composed_gather")


def _ulps(ref, n):
    return n * 2.0 ** (np.floor(np.log2(float(np.abs(ref).max()))) - 7)


def setup(form, mxu, hidden, net="FVGN"):
    """(jcfg, tcfg, jstatic, tstatic, jdyn, tdyn) of the form: both pools'
    Configs with its fields, the JAX statics with the composed operators,
    the port's with the form's, structural operators stored float32 in
    the float32 configuration."""
    from gen_fvgn_tpu.graph.operators import build_mesh_operators as jbuild
    from gen_fvgn_tpu_torch.graph.operators import \
        build_mesh_operators as tbuild
    kw = dict(node_agg="composed", edge_gather="take", fv_packed=True,
              fv_ell=False)
    kw.update(FORMS[form])
    (jc, jp, js, jd), (tc, tp, ts, td) = both_sides(6, hidden, 1, mxu, 2, net)
    bf16_ops = mxu == "bfloat16"
    jops = jbuild(jp.cases[0]["mesh"], jc.order, jp.case_sizes[0], 256,
                  model_ops_bf16=bf16_ops, node_agg="composed")
    tops = tbuild(tp.cases[0]["mesh"], tc.order, tp.case_sizes[0], 256,
                  model_ops_bf16=bf16_ops, node_agg=kw["node_agg"],
                  edge_gather=kw["edge_gather"])
    return (jc.replace(**kw), tc.replace(**kw), js.replace(ops=jops),
            dataclasses.replace(ts, ops=tops), jd, td)


def jax_forms(form, kernels):
    """The JAX switches of the form: its composed gathers on for
    "composed_gather", the Pallas kernels where `kernels`."""
    cg = form == "composed_gather"
    return jax_kernels_on(composed_gather=cg) if kernels \
        else jax_block_forms(cg)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", MODEL_FORMS)
def test_gn_block_and_net_match_flax(form, mxu):
    """GnBlockB at hidden 128 (both outputs; every edge row, padded ones
    too: zero on the composed path in both packages, row 0's data on the
    take path in both) and the FVGN net's output at real nodes."""
    from gen_fvgn_tpu.models.gn_block import GnBlockB as JGn
    jc, tc, js, ts, jd, _ = setup(form, mxu, 128)
    tree, apply_fn = numpy_params(jc, js, jd)
    sim = torch_simulator(tc, tree)
    bf16 = mxu == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None,
                                                           torch.float32)
    rng = np.random.default_rng(12)
    n, e = ts.pos.shape[0], ts.edge_pos_feat.shape[0]
    node = rng.normal(size=(2, n, 128)).astype(np.float32)
    edge = rng.normal(size=(2, e, 128)).astype(np.float32)
    feats = (rng.normal(size=(2, n, 12)).astype(np.float32),
             rng.normal(size=(2, e, 15)).astype(np.float32))
    cast = (lambda a: jnp.asarray(a, jdt)) if bf16 else jnp.asarray
    jgn = JGn(128, jdt, jc.node_agg)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax_forms(form, bf16):
        jn, je = jax.vmap(lambda a, b: jgn.apply(
            {"params": tree["params"]["gn_0"]}, a, b, js))(cast(node),
                                                           cast(edge))
        jnet = jax.vmap(lambda a, b: apply_fn(jt, a, b, js))(
            *map(jnp.asarray, feats))
    with torch.no_grad():
        tn, te = sim.gn_0(torch.from_numpy(node).to(tdt),
                          torch.from_numpy(edge).to(tdt), ts)
        tnet = sim(*map(torch.from_numpy, feats), ts)
    assert tn.dtype == te.dtype == tdt
    real = ts.node_mask.numpy()
    for ref, got, rows, ulps in ((jn, tn, real, 3), (je, te, slice(None), 3),
                                 (jnet, tnet, real, 4)):
        ref = np.asarray(ref, np.float32)[:, rows]
        got = got.float().numpy()[:, rows]
        assert got.shape == ref.shape
        tol = _ulps(ref, ulps) if bf16 else 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_composed_gathers_zero_padded_edge_rows():
    """gsadj·y equals the take path's row gather of adj·y at every real edge
    and is exactly zero at the padded ones (the take path reads row 0
    there); the operators hold small integers, and a pack without them
    refuses the composed form."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.models.gn_block import EdgeBlockB
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop
    _, tc, _, ts, _, _ = setup("composed_gather", "float32", 128)
    ops = ts.ops
    n_real_e = int(ts.edge_pos_feat[:, 2].gt(0).sum())
    y = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, ts.pos.shape[0], 128)).astype(np.float32))
    for comp, take in ((ops.gsadj, ops.gather_s), (ops.gradj, ops.gather_r)):
        got = apply_linop(comp, y)
        ref = apply_linop(take, apply_linop(ops.adj, y))
        np.testing.assert_allclose(got[:, :n_real_e].numpy(),
                                   ref[:, :n_real_e].numpy(), rtol=1e-6,
                                   atol=1e-5)
        assert not got[:, n_real_e:].any()
        assert bool(ref[:, n_real_e:].any())        # row 0's data
        v = comp.fwd.val.numpy()
        assert np.array_equal(v, np.round(v)) and v.min() >= 1
    _, _, _, take_static, _, _ = setup("split", "float32", 128)
    block = EdgeBlockB(128, composed_gather=True)
    with pytest.raises(ValueError, match="gsadj"):
        block(y, torch.zeros(2, ts.edge_pos_feat.shape[0], 128), take_static)
    with pytest.raises(ValueError):
        EdgeBlockB(128, gather_pair=True, composed_gather=True)
    with pytest.raises(ValueError):
        from gen_fvgn_tpu_torch.models.simulator_block import \
            make_simulator_block
        make_simulator_block(Config(edge_gather="wide"), device="cpu")


@pytest.mark.parametrize("node_agg", ["composed", "split"])
def test_composed_gathers_are_gs_adj_and_gr_adj(node_agg):
    """gsadj / gradj and their stored transposes against Gs·A / Gr·A formed
    densely from the mesh's face list, with the NodeBlock's composed
    operators built beside them ("composed") and without ("split"). Beside
    them they are nbr_sᵀ / nbr_rᵀ (A is symmetric) on the same arrays,
    and `.to()` keeps them shared."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.graph.operators import build_mesh_operators
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from torch_port_common import CASE_KW
    pool = EnvPool([], Config(engine="block", batch_size=1, dataset_size=1),
                   cases=[synthetic_case(cavity_quad_mesh(6), **CASE_KW)],
                   device="cpu")
    mesh, sizes = pool.cases[0]["mesh"], pool.case_sizes[0]
    ops = build_mesh_operators(mesh, "2nd", sizes, node_agg=node_agg,
                               edge_gather="composed")
    s, r = mesh["face|face_node"]
    n, e = mesh["node|pos"].shape[0], s.shape[0]
    adj = np.zeros((n, n))
    np.add.at(adj, (r, s), 1.0)
    np.add.at(adj, (s, r), 1.0)
    for op, ends in ((ops.gsadj, s), (ops.gradj, r)):
        want = np.zeros((sizes.n_faces, sizes.n_nodes))
        want[:e, :n] = adj[ends]
        np.testing.assert_array_equal(op.fwd.to_dense().numpy(), want)
        np.testing.assert_array_equal(op.bwd.to_dense().numpy(), want.T)
    if node_agg == "split":
        assert ops.nbr_r is None and ops.nbr_s is None
        return
    for o in (ops, ops.to("cpu")):
        assert o.gsadj.fwd is o.nbr_s.bwd and o.gsadj.bwd is o.nbr_s.fwd
        assert o.gradj.fwd is o.nbr_r.bwd and o.gradj.bwd is o.nbr_r.fwd


def _value_and_grad(jc, js, jd, apply_fn, stats):
    from gen_fvgn_tpu.training.forward import training_loss
    from gen_fvgn_tpu.training.forward_block import forward_batch_block

    def loss_fn(params, uvp):
        out = forward_batch_block(apply_fn, params, jax_norm_state(stats),
                                  jd.replace(uvp=uvp), js, jc,
                                  accumulate_normalizer=True)
        return training_loss(out, jc)
    return jax.jit(jax.value_and_grad(loss_fn))


def _port_loss_and_grads(tc, ts, td, sim, stats):
    from gen_fvgn_tpu_torch.training.forward import training_loss
    from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
    out = forward_batch_block(sim, torch_norm_state(stats), td, ts, tc,
                              accumulate_normalizer=True)
    loss = training_loss(out, tc)
    named = list(sim.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return float(loss.detach()), port_flat(
        {n: torch.zeros_like(p) if g is None else g
         for (n, p), g in zip(named, grads)})


def _norm(g):
    return float(np.sqrt(sum((v ** 2).sum() for v in g.values())))


def _gap(a, b):
    return _norm({k: a[k] - b[k] for k in b}) / _norm(b)


@pytest.mark.parametrize("form", list(FORMS))
def test_train_step_matches_jax_f32(form):
    """FVGN, hidden 32: one training step's loss and gradients."""
    jc, tc, js, ts, jd, td = setup(form, "float32", 32)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd, td = random_state(jd, td, np.asarray(js.node_mask), seed=5)
    with jax_forms(form, False):
        jl, jg = _value_and_grad(jc, js, jd, apply_fn, stats)(
            jax.tree_util.tree_map(jnp.asarray, tree), jd.uvp)
    jg = jax_flat(jg)
    tl, tg = _port_loss_and_grads(tc, ts, td, torch_simulator(tc, tree),
                                  stats)
    assert set(tg) == set(jg)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    assert _gap(tg, jg) < 1e-5
    for k in jg:
        assert np.linalg.norm(tg[k] - jg[k]) <= \
            1e-3 * np.linalg.norm(jg[k]) + 1e-7 * _norm(jg), k


# spmm wrapper calls of one FVGN train step with one GraphNet block, per
# form: forward + backward (split: adj and its transpose at 128, the two
# gathers' transposes; the 64-wide scatters and adj go to csr_matmul;
# wide: also the scatters' two column windows and their transposes;
# composed gathers: gsadj, gradj, the two node-aggregation windows and the
# four transposes). At the Config default of 6 blocks a step: 24, 48, 48.
SPMM_CALLS = {"split": 1 + 3, "wide": 3 + 5, "composed_gather": 4 + 4}


@pytest.mark.parametrize("form", MODEL_FORMS)
def test_train_step_matches_jax_bf16_within_its_own_sensitivity(form):
    """FVGN, hidden 128, the Pallas kernels on the JAX side: the gradient
    within twice the JAX gradient's own move s when one element of the
    input state moves by 1e-3 (measured: gap 0.0047-0.0056 of the norm
    against s = 0.0034-0.0037), every tensor's cosine at least 0.9
    (measured 0.9999), the loss within 1e-3 relative (4.9e-5); and the
    number of spmm wrapper calls (K1 launches on the card) of the form."""
    from gen_fvgn_tpu_torch.ops import spmm as sp
    jc, tc, js, ts, jd, td = setup(form, "bfloat16", 128)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd, td = random_state(jd, td, np.asarray(js.node_mask), seed=5)
    moved = np.asarray(jd.uvp).copy()
    real = np.flatnonzero(np.asarray(js.node_mask))
    moved[0, real[len(real) // 2], 0] += 1e-3
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax_forms(form, True):
        f = _value_and_grad(jc, js, jd, apply_fn, stats)
        jl, jg = f(jp, jd.uvp)
        _, jg_moved = f(jp, jnp.asarray(moved))
    jg, jg_moved = jax_flat(jg), jax_flat(jg_moved)
    s = _gap(jg_moved, jg)
    assert s > 0.0
    with mock.patch.object(sp, "spmm", wraps=sp.spmm) as calls:
        tl, tg = _port_loss_and_grads(tc, ts, td,
                                      torch_simulator(tc, tree), stats)
    assert calls.call_count == SPMM_CALLS[form]
    np.testing.assert_allclose(tl, float(jl), rtol=1e-3)
    assert _gap(tg, jg) <= 2.0 * s, (_gap(tg, jg), s)
    for k in jg:
        a, b = tg[k].ravel(), jg[k].ravel()
        if not b.any():
            assert not a.any(), k
            continue
        assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) \
            >= 0.9, k


@pytest.mark.parametrize("form", ["fv_per_sample", "fv_ell"])
def test_fv_forms_match_jax_and_the_packed_form(form):
    """The FV forms' four losses and both states of one forward against
    JAX's (float32, 1e-5 of their scale), and against the port's default
    form (1e-5): the port runs the same packed products for every FV
    form, and its losses are per sample as JAX's per-sample body's are."""
    from gen_fvgn_tpu.training.forward_block import \
        forward_batch_block as jfwd
    from gen_fvgn_tpu_torch.training.forward_block import \
        forward_batch_block as tfwd
    jc, tc, js, ts, jd, td = setup(form, "float32", 32)
    tree, apply_fn = numpy_params(jc, js, jd)
    stats = numpy_norm_stats()
    jd, td = random_state(jd, td, np.asarray(js.node_mask), seed=7)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jo = jax.jit(lambda p: jfwd(apply_fn, p, jax_norm_state(stats), jd, js,
                                jc))(jt)
    sim = torch_simulator(tc, tree)
    with torch.no_grad():
        to = tfwd(sim, torch_norm_state(stats), td, ts, tc)
        packed = tfwd(sim, torch_norm_state(stats), td, ts,
                      tc.replace(fv_packed=True, fv_ell=False))
    for name in ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press",
                 "uvp_node_new", "uvp_cell_new"):
        ref = np.asarray(getattr(jo, name), np.float64)
        got = getattr(to, name).numpy().astype(np.float64)
        assert got.shape == ref.shape, name
        tol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(
            got, getattr(packed, name).numpy(), rtol=0, atol=tol,
            err_msg=name)


@pytest.mark.parametrize("form", list(FORMS))
def test_options_train_and_serve_through_the_entry_points(tmp_path, form):
    """Each option from the Config alone: `train()` (the pool builds the
    operators the option needs) for 2 epochs on an NS and a wave case,
    then `rollout_block` and `solve_adam_block` from the trained
    simulator; finite losses and states, the padded nodes zero, and the
    losses of the default forms within 1e-3 relative: the options compute
    the same sums, but "split" and "wide" round their intermediate
    aggregation to bf16 before adj (the operand cast of a bf16-stored
    operator in the float32 configuration, as in JAX), the composed
    gathers sum in another order, and Adam's first steps, close to sign
    steps, carry such differences on (measured 1.3e-4 for split and wide,
    1.1e-4 for the composed gathers, 0 for the FV forms)."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_adam_block
    from gen_fvgn_tpu_torch.solve.rollout_block import rollout_block
    from gen_fvgn_tpu_torch.training.loop import train
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from test_torch_loop import _cases
    from test_torch_segment_train import _monitor
    losses = {}
    for name, fields in (("default", {}), (form, FORMS[form])):
        cfg = Config(net="FVGN", hidden_size=32, message_passing_num=1,
                     mxu_dtype="float32", engine="block", batch_size=2,
                     dataset_size=4, max_inner_steps=2, lr=5e-7,
                     average_sequence_length=4, **fields)
        pools = []
        orig = EnvPool.__init__

        def init(self, *a, **k):
            orig(self, *a, **k)
            pools.append(self)
        EnvPool.__init__ = init
        try:
            state = train(cfg, cases=_cases("gen_fvgn_tpu_torch"),
                          log_base_dir=str(tmp_path / name), n_epochs=2,
                          device="cpu")
        finally:
            EnvPool.__init__ = orig
        losses[name] = _monitor(str(tmp_path / name))["loss"]
        assert np.isfinite(losses[name]).all() and state.epoch == 2
    pool, = pools
    assert (pool.statics[0].ops.gsadj is not None) == \
        (form == "composed_gather")
    np.testing.assert_allclose(losses[form], losses["default"], rtol=1e-3)
    dyn, static = pool.gather_block(np.asarray([0, 2])), pool.statics[0]
    hist = rollout_block(cfg, state.simulator, state.norm_state, dyn,
                         static, 2)
    real = static.node_mask.numpy()
    for rec in hist:
        assert np.isfinite(rec["uvp_node"]).all()
        assert not rec["uvp_node"][:, ~real].any()
    _, solved = solve_adam_block(cfg, state.simulator, state.norm_state,
                                 dyn, static, n_time_steps=1, inner_steps=2,
                                 device="cpu")
    assert np.isfinite(solved[-1]["inner_losses"]).all()
