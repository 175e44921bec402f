"""PyTorch port, the segment engine against the JAX package's: the masked
segment sums, the WLSQ accumulation, the interpolations, the FV residual,
the GraphNet blocks, the three nets, `forward_batch` and one train step,
on the synthetic cavity of torch_port_common (its right wall an outflow)
padded as the segment pools pad it (to multiples of 128). Both sides take
the same NumPy batch (the JAX pool's, so both see the same WLSQ statics),
weights, normalizer statistics and state; the JAX side runs one graph under
its vmap, the port the batch-major [B, ...] tensors.

float32: sums and interpolations within 1e-6 of their scale (measured
≤ 4.6e-7), the FV losses within 1e-6 relative (measured ≤ 9.7e-8), the
nets within 1e-4 of the output scale (the limit of
tests/test_torch_models.py), the train step's loss within 1e-5 relative
and its gradients within 1e-4 in norm (the block train step's limits,
tests/test_torch_train_step.py).

bfloat16 (hidden 128; the JAX side on its Pallas kernels in interpret mode,
the port on its kernels' plain versions): the nets within 4 bf16 ulps of
the output scale and a median within 1, the bounds of
tests/test_torch_transolver_nets.py (TransFVGN_v2's maximum within 12,
measured 10.25: see the test); the nets on the 11 x 11 cavity
(144 nodes, padded to 256, so both sides take the fused slice attention;
faces padded to 384, an odd multiple of 128). The bf16 train step is held
as the block step is (tests/test_torch_train_step.py): within twice the
JAX gradient's own move under a 1e-3 change of one input. Each test states
what it measured.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (CASE_KW, _with_outflow, jax_flat,
                               jax_kernels_on, jax_norm_state,
                               numpy_norm_stats, numpy_tree, port_flat,
                               to_plain_dict, torch_norm_state)

LOSSES = ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press")


def configs(net="FVGN", hidden=32, mp=1, mxu="float32", batch=2, **kw):
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu_torch.config import Config as TConfig
    kw = dict(dict(net=net, batch_size=batch, dataset_size=batch,
                   mxu_dtype=mxu, hidden_size=hidden, message_passing_num=mp,
                   engine="segment"), **kw)
    return JConfig(**kw), TConfig(**kw)


def outflow_cavity(pkg, n=6):
    """The cavity of n x n cells with its right wall an outflow, compiled
    again from the node types by package `pkg` (the segment pools keep a
    mesh as it is given), so that its faces carry the outflow type."""
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    geo = importlib.import_module(f"{pkg}.meshes.geometry")
    mesh = _with_outflow(syn.cavity_quad_mesh(n))
    return geo.compile_mesh({k: mesh[k] for k in (
        "node|pos", "node|node_type", "cells_node", "cells_index")})


def cases(pkg, n=6):
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    return [syn.synthetic_case(outflow_cavity(pkg, n), **CASE_KW)]


@functools.lru_cache(maxsize=None)
def pools(n=6, batch=2, seed=0):
    """The JAX and the port's segment pools of the cavity of n x n cells."""
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu_torch.training.pool import EnvPool as TPool
    jc, tc = configs(batch=batch)
    jpool = JPool([], jc, seed=seed, cases=cases("gen_fvgn_tpu", n))
    tpool = TPool([], tc, seed=seed, cases=cases("gen_fvgn_tpu_torch", n),
                  engine="segment", device="cpu")
    return jpool, tpool


def as_port(jbatch):
    """The JAX batch (NumPy MeshSample) as the port's stacked MeshSample of
    CPU tensors."""
    import dataclasses

    from gen_fvgn_tpu_torch.graph.sample import MeshSample
    return MeshSample(**{f.name: torch.from_numpy(
        np.array(getattr(jbatch, f.name)))
        for f in dataclasses.fields(MeshSample)})


def batches(n=6, batch=2, seed=2):
    """(the JAX batch as jnp arrays, the same as port tensors, the NumPy
    batch) with the same random masked state."""
    jpool, _ = pools(n, batch)
    nb = jpool.gather_batch(np.arange(batch))
    rng = np.random.default_rng(seed)
    uvp = rng.normal(size=nb.uvp.shape).astype(np.float32)
    nb = nb.replace(uvp=uvp * nb.node_mask[..., None])
    return jax.tree_util.tree_map(jnp.asarray, nb), as_port(nb), nb


def segment_params(jcfg, nb, seed=0):
    """A flax parameter tree of jcfg.net's segment simulator as nested
    dicts of NumPy arrays (torch_port_common.numpy_tree on the shapes of
    the module's init on one sample), and the JAX apply function."""
    from gen_fvgn_tpu.models.simulator import make_simulator
    from gen_fvgn_tpu.training.forward import relative_edge_features
    sim = make_simulator(jcfg)
    theta = np.broadcast_to(nb.theta[0][None], (nb.uvp.shape[1], 9))
    x = jnp.asarray(np.concatenate([nb.uvp[0], theta], axis=-1))
    e = relative_edge_features(x, jnp.asarray(nb.pos[0]),
                               jnp.asarray(nb.face_node[0]))
    shapes = jax.eval_shape(
        lambda k: sim.init(k, x, e, jnp.asarray(nb.face_node[0]),
                           jnp.asarray(nb.node_mask[0]),
                           jnp.asarray(nb.face_mask[0])),
        jax.random.PRNGKey(0))
    return numpy_tree(shapes, seed), sim.apply


def port_simulator(tcfg, tree):
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    sim = make_simulator(tcfg, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(tree)), strict=True)
    return sim


def scaled_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def ulps(ref, n):
    return n * 2.0 ** (np.floor(np.log2(float(np.abs(ref).max()))) - 7)


# ---- ops ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_and_mean_match_jax(dtype):
    """Masked sums and means over the faces' receiver ids of a batch of two
    padded cavities, in the data's type on both sides (a bf16 sum stays
    bf16). Measured: bit-equal in both types."""
    from gen_fvgn_tpu.ops.segment import segment_mean as jmean
    from gen_fvgn_tpu.ops.segment import segment_sum as jsum
    from gen_fvgn_tpu_torch.ops.segment import segment_mean, segment_sum
    jb, tb, nb = batches()
    rng = np.random.default_rng(3)
    data = rng.normal(size=nb.face_mask.shape + (5,)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    jd = jnp.asarray(data).astype(jdt)
    td = torch.from_numpy(data).to(tdt)
    n = nb.pos.shape[1]
    r = jb.face_node[:, 1]
    for jfn, tfn in ((jsum, segment_sum), (jmean, segment_mean)):
        for mask in (None, "face_mask"):
            jm = None if mask is None else jb.face_mask
            tm = None if mask is None else tb.face_mask
            ref = jax.vmap(lambda d, i, m: jfn(d, i, n, m),
                           in_axes=(0, 0, None if jm is None else 0))(
                jd, r, jm)
            got = tfn(td, tb.face_node[:, 1], n, tm)
            assert got.dtype == tdt and ref.dtype == jdt
            assert tuple(got.shape) == ref.shape == (2, n, 5)
            ref = np.asarray(ref.astype(jnp.float32))
            got = got.float().numpy()
            if dtype == "bfloat16":
                np.testing.assert_array_equal(got, ref)
            else:
                assert scaled_gap(got, ref) <= 1e-6


def test_wlsq_accumulation_and_gradient_match_jax():
    """`accumulate_B` and `node_based_wlsq_precomputed` on the 7-channel
    collection of random fields. Measured: the accumulation bit-equal, the
    gradient 4.6e-7 of its scale."""
    from gen_fvgn_tpu.ops.wlsq import accumulate_B as jacc
    from gen_fvgn_tpu.ops.wlsq import node_based_wlsq_precomputed as jwlsq
    from gen_fvgn_tpu_torch.ops.wlsq import (accumulate_B,
                                             node_based_wlsq_precomputed)
    jb, tb, nb = batches()
    rng = np.random.default_rng(4)
    phi = rng.normal(size=nb.uvp.shape[:2] + (7,)).astype(np.float32)
    ref_b = jax.vmap(lambda p, st, b, cs, m: jacc(p, st, b, "2nd", cs, m))(
        jnp.asarray(phi), jb.stencil, jb.wlsq_B, jb.wlsq_scale,
        jb.stencil_mask)
    got_b = accumulate_B(torch.from_numpy(phi), tb.stencil, tb.wlsq_B, "2nd",
                         tb.wlsq_scale, tb.stencil_mask)
    assert tuple(got_b.shape) == ref_b.shape
    assert scaled_gap(got_b.numpy(), ref_b) <= 1e-6
    ref = jax.vmap(lambda p, st, s, b, cs, m: jwlsq(p, st, s, b, "2nd", cs,
                                                     m))(
        jnp.asarray(phi), jb.stencil, jb.wlsq_S, jb.wlsq_B, jb.wlsq_scale,
        jb.stencil_mask)
    got = node_based_wlsq_precomputed(
        torch.from_numpy(phi), tb.stencil, tb.wlsq_S, tb.wlsq_B, "2nd",
        tb.wlsq_scale, tb.stencil_mask)
    assert tuple(got.shape) == ref.shape == nb.uvp.shape[:2] + (7, 5)
    assert scaled_gap(got.numpy(), ref) <= 1e-6


def test_interpolations_match_jax():
    """node_to_cell (values with gradient and Hessian corrections, and
    gradients with their Hessian), node_to_face (the same), face_to_node
    and cell_to_node (with a gradient correction), masked. Measured: at
    most 5.2e-8 of the scale."""
    from gen_fvgn_tpu.ops import interp as J
    from gen_fvgn_tpu_torch.ops import interp as T
    jb, tb, nb = batches()
    rng = np.random.default_rng(5)
    b, n = nb.uvp.shape[:2]
    nc, e = nb.centroid.shape[1], nb.face_node.shape[2]
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    phi, g, h = arr(b, n, 4), arr(b, n, 4, 2), arr(b, n, 4, 2, 2)
    fphi, cphi, cg = arr(b, e, 3), arr(b, nc, 3), arr(b, nc, 3, 2)
    j, t = jnp.asarray, torch.from_numpy
    cases_ = [
        (lambda p, gr, hs, s: J.node_to_cell(
            p, gr, hs, s.cells_node, s.cells_index, s.pos, s.centroid, nc,
            s.slot_mask),
         lambda p, gr, hs: T.node_to_cell(
             p, gr, hs, tb.cells_node, tb.cells_index, tb.pos, tb.centroid,
             nc, tb.slot_mask), (phi, g, h)),
        (lambda p, gr, hs, s: J.node_to_cell(
            p, gr, None, s.cells_node, s.cells_index, s.pos, s.centroid, nc,
            s.slot_mask),
         lambda p, gr, hs: T.node_to_cell(
             p, gr, None, tb.cells_node, tb.cells_index, tb.pos, tb.centroid,
             nc, tb.slot_mask), (g, h, h)),
        (lambda p, gr, hs, s: J.node_to_face(
            p, gr, hs, s.face_node, s.face_center, s.pos),
         lambda p, gr, hs: T.node_to_face(
             p, gr, hs, tb.face_node, tb.face_center, tb.pos), (phi, g, h)),
        (lambda p, gr, hs, s: J.node_to_face(
            p, None, None, s.face_node, s.face_center, s.pos),
         lambda p, gr, hs: T.node_to_face(
             p, None, None, tb.face_node, tb.face_center, tb.pos),
         (g, g, h)),
        (lambda p, gr, hs, s: J.face_to_node(p, s.face_node, n, s.face_mask),
         lambda p, gr, hs: T.face_to_node(p, tb.face_node, n, tb.face_mask),
         (fphi, g, h)),
        (lambda p, gr, hs, s: J.cell_to_node(
            p, gr, s.cells_node, s.cells_index, s.centroid, s.pos, n,
            s.slot_mask),
         lambda p, gr, hs: T.cell_to_node(
             p, gr, tb.cells_node, tb.cells_index, tb.centroid, tb.pos, n,
             tb.slot_mask), (cphi, cg, h)),
    ]
    for jf, tf, (a, b_, c) in cases_:
        ref = jax.vmap(jf)(j(a), j(b_), j(c), jb)
        got = tf(t(a), t(b_), t(c))
        assert tuple(got.shape) == ref.shape
        assert scaled_gap(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("conserved", [True, False],
                         ids=["conserved", "non-conserved"])
@pytest.mark.parametrize("ncn", [True, False], ids=["ncn", "no-ncn"])
def test_integrate_residuals_matches_jax(conserved, ncn):
    """`integrate_residuals` on random new / hat / old fields: the four
    losses within 1e-6 relative, the smoothed node state and the cell state
    within 1e-6 of their scale. Measured: losses ≤ 9.7e-8, states ≤ 2.0e-7.
    The outflow wall makes the pressure-outlet loss non-zero."""
    from gen_fvgn_tpu.fv.integrator import integrate_residuals as jint
    from gen_fvgn_tpu_torch.fv.integrator import integrate_residuals
    jb, tb, nb = batches()
    rng = np.random.default_rng(6)
    mask = nb.node_mask[..., None]
    arr = lambda c: (rng.normal(size=nb.uvp.shape[:2] + (c,)) * mask
                     ).astype(np.float32)
    new, hat, old = arr(3), arr(2), arr(2)
    lj, rj, cj = jax.vmap(lambda a, b, c, s: jint(
        a, b, c, s, "2nd", conserved, ncn))(
        jnp.asarray(new), jnp.asarray(hat), jnp.asarray(old), jb)
    lt, rt, ct = integrate_residuals(
        torch.from_numpy(new), torch.from_numpy(hat), torch.from_numpy(old),
        tb, "2nd", conserved, ncn)
    for name in ("cont", "mom_x", "mom_y", "press"):
        a, b = getattr(lt, name).numpy(), np.asarray(getattr(lj, name))
        assert a.shape == (2,) and b.shape == (2, 1)
        np.testing.assert_allclose(a, b[:, 0], rtol=1e-6)
    assert float(np.asarray(lj.press).min()) > 0
    assert scaled_gap(rt.numpy(), rj) <= 1e-6
    assert scaled_gap(ct.numpy(), cj) <= 1e-6


# ---- the MLP's padded part ----

@pytest.mark.parametrize("through_mlp", [True, False],
                         ids=["concat", "parts"])
def test_node_mlp_192_wide_part_matches_jax_padding(through_mlp):
    """bf16 at hidden 128: the segment node MLP's one 192-wide part
    (concat(nbr_avg, node_x)), which both wrappers zero-pad with W1's rows
    to 256; forward and the backward's dx and dW1 (192 rows) against the
    JAX fused MLP in interpret mode, within 2 bf16 ulps of their scale (the
    limit of tests/test_torch_fused_mlp.py: float32 sums in another order
    can move a rounding by a step). Measured: the output within 0.25 ulp of
    its scale (58 of 38,400 elements off by one step of their own), dx and
    dW1 within 0.5 ulp. `concat` also runs
    the part through `Mlp`, as the NodeBlock builds it: the same bits as
    `fused_mlp_ln_parts`."""
    from gen_fvgn_tpu.ops.fused_mlp import fused_mlp_ln_parts as jparts
    from gen_fvgn_tpu_torch.ops.fused_mlp import fused_mlp_ln_parts
    rng = np.random.default_rng(7)
    m, k, h = 300, 192, 128
    arr = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    x = arr(m, k)
    w = dict(w1=arr(k, h, sc=k ** -0.5), b1=arr(h, sc=0.1),
             w2=arr(h, h, sc=h ** -0.5), b2=arr(h, sc=0.1),
             w3=arr(h, h, sc=h ** -0.5), b3=arr(h, sc=0.1),
             g=1 + arr(h, sc=0.1), be=arr(h, sc=0.1))
    g_out = arr(m, h)
    names = ("w1", "b1", "w2", "b2", "w3", "b3", "g", "be")

    def jf(xx, *ws):
        return jparts([xx.astype(jnp.bfloat16)], *ws, dtype=jnp.bfloat16)
    with jax_kernels_on():
        ref, vjp = jax.vjp(jf, jnp.asarray(x), *[jnp.asarray(w[n])
                                                  for n in names])
        jdx, jdw1 = vjp(jnp.asarray(g_out).astype(jnp.bfloat16))[:2]
    tx = torch.from_numpy(x).requires_grad_()
    tw = {n: torch.from_numpy(w[n]).requires_grad_() for n in names}
    out = fused_mlp_ln_parts([tx], *[tw[n] for n in names],
                             dtype=torch.bfloat16)
    assert tuple(out.shape) == (m, h) and out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g_out).to(torch.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    got = out.detach().float().numpy()
    assert np.abs(got - ref).max() <= ulps(ref, 2)
    assert tuple(tx.grad.shape) == (m, k) and tuple(tw["w1"].grad.shape) \
        == (k, h)
    for g, r in ((tx.grad, jdx), (tw["w1"].grad, jdw1)):
        r = np.asarray(r, np.float32)
        assert np.abs(g.float().numpy() - r).max() <= ulps(r, 2)
    if not through_mlp:
        return
    # the part as the segment NodeBlock builds it, through Mlp
    from gen_fvgn_tpu_torch.models.mlp import Mlp
    mlp = Mlp(k, h, h, dtype=torch.bfloat16)
    with torch.no_grad():
        for i, (wk, bk) in enumerate((("w1", "b1"), ("w2", "b2"))):
            getattr(mlp, f"hidden_{i}").kernel.copy_(torch.from_numpy(w[wk]))
            getattr(mlp, f"hidden_{i}").bias.copy_(torch.from_numpy(w[bk]))
        mlp.out.kernel.copy_(torch.from_numpy(w["w3"]))
        mlp.out.bias.copy_(torch.from_numpy(w["b3"]))
        mlp.ln.scale.copy_(torch.from_numpy(w["g"]))
        mlp.ln.bias.copy_(torch.from_numpy(w["be"]))
        via_mlp = mlp(torch.from_numpy(x)[None].to(torch.bfloat16))
    np.testing.assert_array_equal(via_mlp[0].float().numpy(), got)


# ---- the GraphNet block and the nets ----

@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_gn_block_matches_flax(mxu):
    """One `GnBlock` (hidden 32 in float32, 128 in bf16) on random node and
    edge streams. Measured: float32 3.8e-7 of the output scale (bound
    1e-4); bf16 within 0.5 ulp (bound 3 ulps, as for one block of the block
    engine, tests/test_torch_models.py)."""
    from gen_fvgn_tpu.models.gn import GnBlock as JGn
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.models.gn import GnBlock
    jb, tb, nb = batches()
    h = 32 if mxu == "float32" else 128
    jdt = jnp.bfloat16 if mxu == "bfloat16" else None
    tdt = torch.bfloat16 if mxu == "bfloat16" else None
    rng = np.random.default_rng(8)
    b, n = nb.uvp.shape[:2]
    e = nb.face_node.shape[2]
    node = rng.normal(size=(b, n, h)).astype(np.float32)
    edge = rng.normal(size=(b, e, h)).astype(np.float32)
    jblock = JGn(h, jdt)
    shapes = jax.eval_shape(
        lambda k: jblock.init(k, jnp.asarray(node[0]), jnp.asarray(edge[0]),
                              jb.face_node[0], jb.face_mask[0]),
        jax.random.PRNGKey(0))
    tree = numpy_tree(shapes, 1)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    cast = (lambda a: jnp.asarray(a).astype(jdt)) if jdt else jnp.asarray
    with jax_kernels_on():
        rn, re = jax.vmap(lambda x, y, f, m: jblock.apply(jt, x, y, f, m))(
            cast(node), cast(edge), jb.face_node, jb.face_mask)
    block = GnBlock(h, tdt)
    block.load_state_dict(params_from_flax(tree), strict=True)
    tcast = (lambda a: torch.from_numpy(a).to(tdt)) if tdt \
        else torch.from_numpy
    with torch.no_grad():
        gn, ge = block(tcast(node), tcast(edge), tb.face_node, tb.face_mask)
    for got, ref in ((gn, rn), (ge, re)):
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        got = got.float().numpy()
        if mxu == "float32":
            assert scaled_gap(got, ref) <= 1e-4
        else:
            assert got.dtype == np.float32
            assert np.abs(got - ref).max() <= ulps(ref, 3)


NETS = ("FVGN", "TransFVGN_v1", "TransFVGN_v2")


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_segment_nets_match_flax(net, mxu):
    """The three nets on random node and edge features: float32 (hidden 32,
    the 6 x 6 cavity) within 1e-4 of the output scale; bf16 (hidden 128,
    the 11 x 11 cavity, where every fused dispatch fires) within 4 ulps of
    the scale and a median within 1 (the block nets' bounds), but
    TransFVGN_v2 within 12 ulps: its second Transolver block amplifies the
    one-ulp differences of its input (given the JAX side's own input that
    block agrees to 1 ulp in 0.15% of its elements, and the JAX net itself
    moves by 0.28 when its inputs move by 1e-3 relative). Measured:
    float32 v2 1.6e-6, FVGN 5.7e-7 of the scale; bf16 FVGN 1 ulp (median
    0), v1 1.5 ulps (median 0.25), v2 0.64 at scale 9.4 (10.25 ulps,
    median 0.75)."""
    n = 6 if mxu == "float32" else 11
    hidden = 32 if mxu == "float32" else 128
    jc, tc = configs(net, hidden=hidden, mxu=mxu)
    jb, tb, nb = batches(n)
    tree, apply_fn = segment_params(jc, nb)
    sim = port_simulator(tc, tree)
    rng = np.random.default_rng(9)
    b, nn_ = nb.uvp.shape[:2]
    e = nb.face_node.shape[2]
    node = rng.normal(size=(b, nn_, 12)).astype(np.float32)
    edge = rng.normal(size=(b, e, 15)).astype(np.float32)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax_kernels_on():
        ref = np.asarray(jax.vmap(lambda x, y, f, m, fm: apply_fn(
            jt, x, y, f, m, fm))(jnp.asarray(node), jnp.asarray(edge),
                                 jb.face_node, jb.node_mask, jb.face_mask),
            np.float32)
    with torch.no_grad():
        out = sim(torch.from_numpy(node), torch.from_numpy(edge),
                  tb.face_node, tb.node_mask, tb.face_mask)
    real = nb.node_mask
    got = out.float().numpy()
    assert got.shape == ref.shape == (b, nn_, 3)
    if mxu == "float32":
        assert out.dtype == torch.float32
        assert scaled_gap(got[real], ref[real]) <= 1e-4
    else:
        assert out.dtype == torch.bfloat16
        gap = np.abs(got - ref)[real]
        assert gap.max() <= ulps(ref, 12 if net == "TransFVGN_v2" else 4)
        assert np.median(gap) <= ulps(ref, 1)


def test_weights_load_into_both_engines_nets():
    """One flax tree (of the JAX segment TransFVGN_v2) loads, strictly, into
    the port's segment net and its block net, and the two port nets draw
    the same weights from the same seed."""
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    jc, tc = configs("TransFVGN_v2")
    _, _, nb = batches()
    tree, _ = segment_params(jc, nb)
    sd = params_from_flax(to_plain_dict(tree))
    seg = make_simulator(tc, device="cpu", seed=3)
    blk = make_simulator_block(tc, device="cpu", seed=3)
    assert set(seg.state_dict()) == set(blk.state_dict()) == set(sd)
    for k, v in seg.state_dict().items():
        assert torch.equal(v, blk.state_dict()[k]), k
    seg.load_state_dict(sd, strict=True)
    blk.load_state_dict(sd, strict=True)
    for k, v in sd.items():
        assert torch.equal(seg.state_dict()[k], v)
        assert torch.equal(blk.state_dict()[k], v)


# ---- forward_batch and one train step ----

def _forward_both(jc, tc, n, accumulate, seed=0):
    from gen_fvgn_tpu.training.forward import forward_batch as jfwd
    from gen_fvgn_tpu_torch.training.forward import forward_batch
    jb, tb, nb = batches(n)
    tree, apply_fn = segment_params(jc, nb, seed)
    stats = numpy_norm_stats()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax_kernels_on():
        jo = jfwd(apply_fn, jt, jax_norm_state(stats), jb, jc,
                  accumulate_normalizer=accumulate)
    with torch.no_grad():
        to = forward_batch(port_simulator(tc, tree), torch_norm_state(stats),
                           tb, tc, accumulate_normalizer=accumulate)
    return jo, to, nb


@pytest.mark.parametrize("variant", [
    dict(), dict(integrator="explicit", norm_uvp=False),
    dict(integrator="implicit", norm_global=False),
    dict(conserved_form=False, ncn_smooth=False)],
    ids=["imex", "explicit-no-norm-uvp", "implicit-no-norm-global",
         "non-conserved-no-ncn"])
def test_forward_batch_matches_jax(variant):
    """TransFVGN_v2 float32 (hidden 32): the four per-sample losses within
    1e-5 relative, the dimensional node and cell states within 1e-4 of
    their scale, the accumulated normalizer equal to 1e-6. Measured (imex):
    losses ≤ 7.5e-7, states ≤ 4.7e-7, the normalizer bit-equal."""
    jc, tc = configs("TransFVGN_v2", **variant)
    jo, to, nb = _forward_both(jc, tc, 6, True)
    for k in LOSSES:
        a, b = getattr(to, k).numpy(), np.asarray(getattr(jo, k))
        assert a.shape == b.shape == (2, 1)
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for k in ("uvp_node_new", "uvp_cell_new"):
        assert scaled_gap(getattr(to, k).numpy(), getattr(jo, k)) <= 1e-4
    for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_acc"):
        np.testing.assert_allclose(getattr(to.norm_state, f).numpy(),
                                   np.asarray(getattr(jo.norm_state, f)),
                                   rtol=1e-6)
    if tc.ncn_smooth:      # the smoothed state is zero on padded nodes
        assert not np.abs(to.uvp_node_new.numpy()[:, ~nb.node_mask[0]]).any()


def _grads_both(jc, tc, n, seed=5, move=None):
    """(JAX loss, JAX gradients, port loss, port gradients[, JAX gradients
    with one input element moved by `move`]) of the train step's loss
    (forward with normalizer accumulation, then `training_loss`)."""
    from gen_fvgn_tpu.training.forward import forward_batch as jfwd
    from gen_fvgn_tpu.training.forward import training_loss as jloss
    from gen_fvgn_tpu_torch.training.forward import (forward_batch,
                                                     training_loss)
    jb, tb, nb = batches(n, seed=seed)
    tree, apply_fn = segment_params(jc, nb)
    stats = numpy_norm_stats()

    def loss_fn(params, uvp):
        out = jfwd(apply_fn, params, jax_norm_state(stats),
                   jb.replace(uvp=uvp), jc, accumulate_normalizer=True)
        return jloss(out, jc)
    f = jax.jit(jax.value_and_grad(loss_fn))
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    with jax_kernels_on():
        jl, jg = f(jt, jb.uvp)
        moved = None
        if move is not None:
            u = np.array(nb.uvp)
            real = np.flatnonzero(nb.node_mask[0])
            u[0, real[len(real) // 2], 0] += move
            moved = jax_flat(f(jt, jnp.asarray(u))[1])
    sim = port_simulator(tc, tree)
    loss = training_loss(forward_batch(sim, torch_norm_state(stats), tb, tc,
                                       accumulate_normalizer=True), tc)
    named = list(sim.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    tg = port_flat({nm: torch.zeros_like(p) if g is None else g
                    for (nm, p), g in zip(named, grads)})
    return float(jl), jax_flat(jg), float(loss.detach()), tg, moved


def rel_gap(a, b):
    num = sum(((a[k] - b[k]) ** 2).sum() for k in b)
    return float(np.sqrt(num / sum((v ** 2).sum() for v in b.values())))


@pytest.mark.parametrize("net", ["TransFVGN_v2", "FVGN"])
def test_train_loss_and_grads_match_jax_f32(net):
    """The loss within 1e-5 relative, the whole gradient within 1e-4 of its
    norm and every tensor within 1e-3 of its own norm (the block step's
    limits). Measured: the losses bit-equal, the gradients 7.1e-7
    (TransFVGN_v2) and 6.0e-7 (FVGN) of their norm."""
    jc, tc = configs(net)
    jl, jg, tl, tg, _ = _grads_both(jc, tc, 6)
    assert set(tg) == set(jg)
    assert all(tg[k].shape == jg[k].shape for k in jg)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert rel_gap(tg, jg) <= 1e-4
    scale = np.sqrt(sum((v ** 2).sum() for v in jg.values()))
    for k in jg:
        gap = np.linalg.norm(tg[k] - jg[k])
        assert gap <= 1e-3 * np.linalg.norm(jg[k]) + 1e-7 * scale, k


def test_train_grads_match_jax_bf16_within_its_own_sensitivity():
    """TransFVGN_v2 in bf16 (hidden 128, the 11 x 11 cavity): the port's
    gradient within 2·s of the JAX gradient, where s is the JAX gradient's
    own move when one element of the state moves by 1e-3; its norm within
    2·s; the loss within 1e-3 relative (the block step's bounds).
    Measured: s = 0.0046, the gap 0.0050 (1.08 s), the loss 7.0e-6."""
    jc, tc = configs("TransFVGN_v2", hidden=128, mxu="bfloat16")
    jl, jg, tl, tg, moved = _grads_both(jc, tc, 11, move=1e-3)
    s = rel_gap(moved, jg)
    assert s > 0.0
    assert set(tg) == set(jg)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    gap = rel_gap(tg, jg)
    assert gap <= 2.0 * s, (gap, s)
    norm = lambda g: np.sqrt(sum((v ** 2).sum() for v in g.values()))
    assert abs(norm(tg) / norm(jg) - 1.0) <= 2.0 * s
