"""PyTorch port, the gradients of the model's modules against `jax.vjp` of
their flax counterparts: `Encoder`, `Decoder`, `GnBlockB`,
`PhysicsAttention`, `TransolverBlock` and `AttnProcessorB`, with the same
NumPy weights (converted by `convert.params_from_flax`, compared back key
by key through `convert.flax_paths`), inputs and output cotangents.
The GraphNet-side modules are those of a small TransFVGN_v2 on the
synthetic cavity; `PhysicsAttention` and `TransolverBlock` stand alone at
N = 256 nodes with a padded tail in the mask.

float32 at hidden 32 (plain-layer forms; structural operators stored
float32 on both sides): every gradient within 1e-4 of its own norm.

bfloat16 at hidden 128, where every kernel's dispatch fires on both sides
(the fused MLPs, the spmm, the fused slice pooling and the pre-LN MLP;
the JAX side's Pallas kernels in interpret mode, the port's plain
versions), and the plain-layer Transolver forms at hidden 32 in bf16.
Both sides round at the same points, but a float32 sum in another order
can move one bf16 rounding, and a rounding moved in the forward moves the
backward's operands: each gradient within 3e-2 of its own norm (the
product of a few 2⁻⁸ roundings along a chain of products), and the
input gradients within 3e-2 too.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (both_sides, f32_operator_statics, jax_flat,
                               jax_kernels_on, numpy_params, numpy_tree,
                               port_flat, torch_simulator)
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

HEADS, SLICES = 8, 32
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@functools.lru_cache(maxsize=None)
def _net(dtype, hidden):
    """(JAX static, port static, NumPy tree, port TransFVGN_v2 simulator)
    of the small cavity, built once per process."""
    args = (6, hidden, 1, dtype, 2)
    (jc, _, js, jd), (tc, _, ts, _) = both_sides(*args, net="TransFVGN_v2")
    if dtype == "float32":
        js, ts = f32_operator_statics(*args, net="TransFVGN_v2")
    tree, _ = numpy_params(jc, js, jd)
    return js, ts, tree, torch_simulator(tc, tree)


def _standalone(kind, dtype, hidden, n=256):
    """A flax PhysicsAttention or TransolverBlock with NumPy weights, the
    port's module with the same weights, and a node mask with a padded
    tail, as the block engine pads."""
    from gen_fvgn_tpu.models.transolver import (PhysicsAttention as JAttn,
                                                TransolverBlock as JBlock)
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.models.transolver import (PhysicsAttention,
                                                      TransolverBlock)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    jcls, tcls = (JAttn, PhysicsAttention) if kind == "attention" \
        else (JBlock, TransolverBlock)
    jm = jcls(hidden, HEADS, SLICES, dtype=jdt)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((n, hidden), jdt or jnp.float32),
                            jnp.ones(n))
    params = numpy_tree(shapes, seed=hidden)["params"]
    tm = tcls(hidden, HEADS, SLICES, dtype=tdt)
    tm.load_state_dict(params_from_flax({"params": params}), strict=True)
    mask = np.ones(n, np.float32)
    mask[int(0.8 * n):] = 0.0
    return (jm, params, tm, (jnp.asarray(mask),),
            (torch.from_numpy(mask).to(torch.bool),),
            [((2, n, hidden), True)])


def _module(kind, dtype, hidden):
    """(flax module, its params, port module, JAX extra args, port extra
    args, input shapes and whether each input is in the stream type)."""
    from gen_fvgn_tpu.models import gn as jgn
    from gen_fvgn_tpu.models.gn_block import GnBlockB
    from gen_fvgn_tpu.models.simulator_block import AttnProcessorB
    if kind in ("attention", "transolver"):
        return _standalone(kind, dtype, hidden)
    js, ts, tree, sim = _net(dtype, hidden)
    sim.zero_grad(set_to_none=True)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    p = tree["params"]
    n, e = ts.pos.shape[0], ts.edge_pos_feat.shape[0]
    h = hidden
    node, edge = ((2, n, h), True), ((2, e, h), True)
    if kind == "encoder":
        return (jgn.Encoder(h, jdt), p["encoder"], sim.encoder, (), (),
                [((2, n, 12), False), ((2, e, 15), False)])
    if kind == "decoder":
        return (jgn.Decoder(3, h, jdt), p["decoder"], sim.decoder, (), (),
                [node])
    if kind == "gn_block":
        return (GnBlockB(h, jdt, "composed"), p["processor_0"]["gn_0"],
                sim.processor_0.gn_0, (js,), (ts,), [node, edge])
    return (AttnProcessorB(h, 1, HEADS, SLICES, jdt, "composed"),
            p["processor_0"], sim.processor_0, (js,), (ts,), [node, edge])


CASES = [(k, "float32", 32) for k in ("encoder", "decoder", "gn_block",
                                       "attention", "transolver",
                                       "processor")] \
    + [(k, "bfloat16", 128) for k in ("encoder", "decoder", "gn_block",
                                       "attention", "transolver",
                                       "processor")] \
    + [(k, "bfloat16", 32) for k in ("attention", "transolver")]


@pytest.mark.parametrize("kind,dtype,hidden", CASES)
def test_module_gradients_match_jax_vjp(kind, dtype, hidden):
    from gen_fvgn_tpu_torch.models.transolver import PhysicsAttention
    jm, params, tm, jextra, textra, shapes = _module(kind, dtype, hidden)
    bf16 = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    rng = np.random.default_rng(50 + hidden)
    xs = [rng.normal(size=s).astype(np.float32) for s, _ in shapes]
    if bf16:
        xs = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
              if stream else x for x, (_, stream) in zip(xs, shapes)]

    def jfn(p, *ins):
        out = jax.vmap(lambda *a: jm.apply({"params": p}, *a, *jextra))(*ins)
        return out if isinstance(out, tuple) else (out,)
    jins = [jnp.asarray(x, jdt) if stream else jnp.asarray(x)
            for x, (_, stream) in zip(xs, shapes)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    with jax_kernels_on():
        jouts, vjp = jax.vjp(jfn, jp, *jins)
        cots = [rng.normal(size=o.shape).astype(np.float32) for o in jouts]
        jgrads = vjp(tuple(jnp.asarray(c, o.dtype)
                           for c, o in zip(cots, jouts)))
    jg = jax_flat(jgrads[0])

    tins = [(torch.from_numpy(x).to(tdt) if stream else torch.from_numpy(x))
            .requires_grad_() for x, (_, stream) in zip(xs, shapes)]
    touts = tm(*tins, *textra)
    touts = touts if isinstance(touts, tuple) else (touts,)
    assert [o.dtype for o in touts] == [
        torch.bfloat16 if o.dtype == jnp.bfloat16 else torch.float32
        for o in jouts]
    if kind == "attention" and bf16 and hidden == 128:
        assert isinstance(tm, PhysicsAttention) and tm.fused(
            tins[0].shape[1], hidden)
    torch.autograd.backward(touts, [torch.from_numpy(c).to(o.dtype)
                                    for c, o in zip(cots, touts)])
    tg = port_flat({n: torch.zeros_like(q) if q.grad is None else q.grad
                    for n, q in tm.named_parameters()})
    assert set(tg) == set(jg)
    tol = TOL[dtype]
    for k in jg:
        assert tg[k].shape == jg[k].shape, k
        gap = np.linalg.norm(tg[k] - jg[k])
        assert gap <= tol * np.linalg.norm(jg[k]) + 1e-12, \
            (k, gap / max(np.linalg.norm(jg[k]), 1e-30))
    for i, (t, j) in enumerate(zip(tins, jgrads[1:])):
        j = np.asarray(j, np.float64)
        got = t.grad.double().numpy()
        assert got.shape == j.shape and t.grad.dtype == t.dtype
        gap = np.linalg.norm(got - j)
        assert gap <= tol * np.linalg.norm(j) + 1e-12, (i, gap)
