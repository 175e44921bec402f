"""Shared fixtures of the tests/test_torch_*.py files: the same small
synthetic cavity built once by the JAX package and once by the PyTorch port,
with weights, normalizer statistics and states made with NumPy from a seed
and handed to both sides."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

CASE_KW = dict(continuity=1, convection=1, grad_p=1, mu=0.05, sigma=(1, 1, 1))
OUTFLOW = 2     # NodeType.OUTFLOW in both packages


def _with_outflow(mesh):
    """Turn the interior of the right wall into an OUTFLOW boundary, so the
    pressure-outlet residual is exercised (the plain cavity has no outflow
    face). The pools recompile the mesh from the node types."""
    mesh = dict(mesh)
    pos = mesh["node|pos"]
    nt = np.array(mesh["node|node_type"]).reshape(-1)
    right = (pos[:, 0] == pos[:, 0].max()) & (pos[:, 1] > pos[:, 1].min()) \
        & (pos[:, 1] < pos[:, 1].max())
    nt[right] = OUTFLOW
    mesh["node|node_type"] = nt
    return mesh


def jax_side(n, hidden, mp, mxu, batch):
    from gen_fvgn_tpu.config import Config
    from gen_fvgn_tpu.meshes.synthetic import cavity_quad_mesh, synthetic_case
    from gen_fvgn_tpu.training.pool import EnvPool
    cfg = Config(net="FVGN", batch_size=batch, dataset_size=batch,
                 mxu_dtype=mxu, hidden_size=hidden, message_passing_num=mp,
                 engine="block")
    case = synthetic_case(_with_outflow(cavity_quad_mesh(n)), **CASE_KW)
    pool = EnvPool([], cfg, seed=0, cases=[case], engine="block")
    dyn = pool.gather_block(np.arange(batch))
    return cfg, pool, pool.statics[0], dyn


def torch_side(n, hidden, mp, mxu, batch):
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net="FVGN", batch_size=batch, dataset_size=batch,
                 mxu_dtype=mxu, hidden_size=hidden, message_passing_num=mp,
                 engine="block")
    case = synthetic_case(_with_outflow(cavity_quad_mesh(n)), **CASE_KW)
    pool = EnvPool([], cfg, seed=0, cases=[case], device="cpu")
    dyn = pool.gather_block(np.arange(batch))
    return cfg, pool, pool.statics[0], dyn


@functools.lru_cache(maxsize=None)
def both_sides(n=6, hidden=32, mp=1, mxu="float32", batch=2):
    """((jcfg, jpool, jstatic, jdyn), (tcfg, tpool, tstatic, tdyn))."""
    return jax_side(n, hidden, mp, mxu, batch), \
        torch_side(n, hidden, mp, mxu, batch)


def f32_operator_statics(n=6, hidden=32, mp=1, mxu="float32", batch=2):
    """Both StaticPacks with the structural operators stored float32, so
    that no operand is rounded to bfloat16 inside an apply. With the default
    bf16-stored operators a last-bit float32 difference between the two
    frameworks can flip such a rounding (a 2^-9 relative jump of one
    element), which the comparison of the algorithm should not see."""
    import dataclasses

    from gen_fvgn_tpu.graph.operators import build_mesh_operators as jbuild
    from gen_fvgn_tpu_torch.graph.operators import \
        build_mesh_operators as tbuild
    (jc, jp, js, _), (tc, tp, ts, _) = both_sides(n, hidden, mp, mxu, batch)
    jops = jbuild(jp.cases[0]["mesh"], jc.order, jp.case_sizes[0], 256,
                  model_ops_bf16=False, node_agg="composed")
    tops = tbuild(tp.cases[0]["mesh"], tc.order, tp.case_sizes[0], 256,
                  model_ops_bf16=False, node_agg="composed")
    return js.replace(ops=jops), dataclasses.replace(ts, ops=tops)


def numpy_params(jcfg, jstatic, jdyn, seed=0):
    """A flax parameter tree of FVGNSimulatorB as nested dicts of NumPy
    arrays: shapes from the JAX package's own init, values from a NumPy
    seed (non-zero biases, non-trivial LayerNorm scale/bias)."""
    from gen_fvgn_tpu.training.train_block import init_train_state_block
    state, apply_fn = init_train_state_block(jcfg, jdyn, jstatic, seed=0)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(shape[0])
                    ).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, state.params)
    return jax.tree_util.tree_map(np.asarray, tree), apply_fn


def to_plain_dict(tree):
    """flax FrozenDict / dict → plain nested dict of NumPy arrays."""
    if hasattr(tree, "items"):
        return {k: to_plain_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def numpy_norm_stats(size=9, seed=1):
    rng = np.random.default_rng(seed)
    count = 50.0
    mean = rng.normal(size=size).astype(np.float32)
    std = (0.5 + rng.uniform(size=size)).astype(np.float32)
    acc_sum = mean * count
    acc_sum_sq = (std ** 2 + mean ** 2) * count
    return dict(acc_sum=acc_sum.astype(np.float32),
                acc_sum_sq=acc_sum_sq.astype(np.float32),
                acc_count=np.float32(count), num_acc=np.float32(3.0))


def jax_norm_state(stats):
    from gen_fvgn_tpu.training.normalizer import NormalizerState
    return NormalizerState(**{k: jnp.asarray(v) for k, v in stats.items()})


def torch_norm_state(stats):
    from gen_fvgn_tpu_torch.convert import normalizer_from_numpy
    return normalizer_from_numpy(device="cpu", **stats)


def torch_simulator(tcfg, np_tree):
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    sim = make_simulator_block(tcfg, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(np_tree)), strict=True)
    return sim


def random_state(jdyn, tdyn, node_mask, seed=2):
    """The same random (masked) uvp state in both DynamicPacks."""
    rng = np.random.default_rng(seed)
    uvp = rng.normal(size=tuple(tdyn.uvp.shape)).astype(np.float32)
    uvp *= np.asarray(node_mask, np.float32)[None, :, None]
    return (jdyn.replace(uvp=jnp.asarray(uvp)),
            tdyn.replace(uvp=torch.from_numpy(uvp.copy())))
