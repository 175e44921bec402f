"""PyTorch port, spatial parallelism against the JAX package: the port's
block train steps on gloo ranks spawned on the CPU (sp = 2 on 2 ranks,
dp = 2 x sp = 2 on 4; `tools/sp_check.run_steps`) from the JAX
initialisation's weights, against the JAX package's unsharded step and
its step on the (dp, sp) virtual mesh (`make_dp_sp_mesh(1, 2)` /
`(2, 2)`, `shard_static_sp`, `shard_block_batch_dp`; the 8 virtual CPU
devices of tests/conftest.py), and the mixed-case step against JAX's
single-device mixed step. The sizes and the mesh are
tests/test_torch_sp.py's (`cavity_quad_mesh(20)` padded to 512 rows, so
that both ranks hold real rows).

Limits, the JAX tests' own: float32 loss rtol 1e-5, new states rtol 1e-4 +
atol 1e-5, parameters rtol 1e-3 + atol 2.2·lr (`tests/test_parallel.py::
test_block_engine_dp_sp_matches_single_device`); bfloat16 loss rtol 1e-4,
states rtol 1e-3 + atol 1e-3, parameters rtol 1e-3 + atol 2.2·lr
(`tests/test_sp_fused.py::test_block_step_sp_fused_matches_unsharded`);
the mixed step's loss rtol 1e-5 + atol 1e-7 and parameters rtol 1e-3 +
atol 4.4·lr (`test_sp_fused.py::test_mixed_sp_matches_single_device`).
The step-1 gradients (the port's Adam first moment against optax's `mu`
after one step: (1 − β1)·g on both sides) are held too
(`tools/sp_check.grad_gaps`: the largest gap over the step's largest
gradient element): within 1e-3 in float32 and 5e-2 in bfloat16, where a
stray factor of sp_devices would be a gap of 0.5 or more. Measured: float32
6.6e-5 (against JAX's unsharded and its sharded step alike), mixed
1.7e-5, bfloat16 1.9e-2 and 2.1e-2 (the two frameworks round the bf16
stream at different points).
"""

import numpy as np
import pytest

import jax

from test_torch_sp import BASE, MIXED, _cases
from torch_port_common import jax_flat, to_plain_dict
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

LR = 5e-5
LIMITS = {"float32": dict(loss=1e-5, rtol=1e-4, atol=1e-5, grads=1e-3),
          "bfloat16": dict(loss=1e-4, rtol=1e-3, atol=1e-3, grads=5e-2)}


def _jax_start(cfg_kw, mixed=False):
    """The JAX block pool padded to tile x sp, its first batch (of the
    mixed draw where `mixed`), statics and initialisation."""
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.training.pool import EnvPool
    from gen_fvgn_tpu.training.train_block import init_train_state_block
    kw = {k: v for k, v in cfg_kw.items() if k != "sp_devices"}
    jcfg = JConfig(**kw)
    pool = EnvPool([], jcfg, seed=0, cases=_cases("gen_fvgn_tpu", mixed),
                   engine="block", pad_multiple=256 * cfg_kw["sp_devices"])
    jcfg = jcfg.replace(dataset_size=len(pool))
    if mixed:
        batch = pool.mixed_block_batches(step_seed=0)[0]
        state, apply_fn = init_train_state_block(
            jcfg, pool.gather_block(batch[0][1]), pool.statics[0], seed=0)
        return jcfg, (pool, batch), state, apply_fn
    ci, idxs = pool.block_batches(step_seed=0)[0]
    dyn, static = pool.gather_block(idxs), pool.statics[ci]
    state, apply_fn = init_train_state_block(jcfg, dyn, static, seed=0)
    return jcfg, (dyn, static), state, apply_fn


def _jax_one(jcfg, data, state, apply_fn):
    from gen_fvgn_tpu.training.train_block import make_train_step_block
    return make_train_step_block(jcfg, apply_fn, donate=False)(state, *data)


def _jax_sharded(jcfg, data, state, apply_fn, dp, sp):
    from gen_fvgn_tpu.parallel.sp import (make_dp_sp_mesh, replicate_state,
                                          shard_block_batch_dp,
                                          shard_static_sp)
    from gen_fvgn_tpu.training.train_block import make_train_step_block
    dyn, static = data
    mesh = make_dp_sp_mesh(dp, sp)
    step = make_train_step_block(jcfg, apply_fn, donate=False)
    return step(replicate_state(state, mesh),
                shard_block_batch_dp(dyn, mesh, batch_size=8),
                shard_static_sp(static, mesh))


def _jax_mixed(jcfg, data, state, apply_fn):
    from gen_fvgn_tpu.training.train_block import MixedTrainStepBlock
    pool, batch = data
    s, m = MixedTrainStepBlock(jcfg, apply_fn).run_batch(
        state, batch, pool.gather_block, pool.statics)
    return s, m, None


def _port_start(cfg_kw, jparams, path):
    """A port checkpoint slot holding the JAX initialisation's weights."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.training.train_block import \
        init_train_state_block
    state, sim = init_train_state_block(Config(**cfg_kw), seed=5,
                                        device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(
        jax.tree_util.tree_map(np.asarray, jparams))))
    save_state(state, str(path))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX starts, then the port's runs on spawned ranks (the sp = 2
    specs in one spawn of 2 ranks, dp2 x sp2 in one of 4, each from its
    JAX start's weights) in a thread while the JAX steps run in this
    process. dp2 x sp2's unsharded JAX step is the float32 spec's (the
    same batch and weights)."""
    import threading

    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from torch_sp_workers import several
    tmp = tmp_path_factory.mktemp("sp_jax")
    T = "gen_fvgn_tpu_torch"
    cfgs = {"f32": BASE, "bf16": dict(BASE, mxu_dtype="bfloat16"),
            "mixed": MIXED}
    starts = {k: _jax_start(kw, mixed=k == "mixed") for k, kw in cfgs.items()}
    specs = {}
    for name, kw in dict(cfgs, dp2xsp2=dict(BASE, dp_devices=2)).items():
        mixed = name == "mixed"
        st = "f32" if name == "dp2xsp2" else name
        specs[name] = dict(
            cfg=kw, cases=_cases(T, mixed), mixed=mixed, device="cpu",
            steps=1, seed=0, ranks=True,
            start=_port_start(cfgs[st], starts[st][2].params,
                              tmp / f"{name}.state"))
    two = ["f32", "bf16", "mixed"]
    port = {}

    def ranks():
        try:
            port[2] = spawn(several, 2, [("steps", specs[k]) for k in two],
                            workdir=str(tmp))
            port[4] = spawn(several, 4, [("steps", specs["dp2xsp2"])],
                            workdir=str(tmp))
        except BaseException as exc:     # raised below, in the fixture
            port["error"] = exc
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        f32, bf16 = starts["f32"], starts["bf16"]
        out = {"f32": dict(jax=_jax_one(*f32),
                           jax_sp=_jax_sharded(*f32, dp=1, sp=2)),
               "bf16": dict(jax=_jax_one(*bf16),
                            jax_sp=_jax_sharded(*bf16, dp=1, sp=2)),
               "mixed": dict(jax=_jax_mixed(*starts["mixed"]))}
        out["dp2xsp2"] = dict(jax=out["f32"]["jax"],
                              jax_sp=_jax_sharded(*f32, dp=2, sp=2))
    finally:
        thread.join()
    if "error" in port:
        raise port["error"]
    for i, name in enumerate(two):
        out[name]["ranks"] = [r[i] for r in port[2]]
    out["dp2xsp2"]["ranks"] = [r[0] for r in port[4]]
    return out


def _held(got, s_j, m_j, u_j, limits, p_atol):
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(m_j.loss),
                               rtol=limits["loss"], atol=1e-7)
    if u_j is not None:
        np.testing.assert_allclose(got["uvp_first"],
                                   np.asarray(u_j, np.float32),
                                   rtol=limits["rtol"], atol=limits["atol"])
    jp = jax_flat(s_j.params)
    assert set(jp) == set(got["params"])
    for k, v in jp.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-3,
                                   atol=p_atol, err_msg=k)
    from gen_fvgn_tpu_torch.tools.sp_check import grad_gaps
    mu = jax_flat(s_j.opt_state.inner_state[0].mu)
    assert set(mu) == set(got["mu1"])
    assert grad_gaps(got["mu1"], mu) <= limits["grads"]


@pytest.mark.parametrize("name", ["f32", "bf16", "dp2xsp2"])
@pytest.mark.parametrize("against", ["jax", "jax_sp"])
def test_sp_step_matches_jax(runs, name, against):
    """Rank 0 against JAX's unsharded step ("jax") and JAX's step on the
    (dp, sp) virtual mesh ("jax_sp") on the same batch from the same
    weights: loss, new states, parameters and step-1 gradients within the
    JAX sp tests' limits (the module's docstring)."""
    r = runs[name]
    s_j, m_j, u_j = r[against]
    dtype = "bfloat16" if name == "bf16" else "float32"
    _held(r["ranks"][0], s_j, m_j, u_j, LIMITS[dtype], 2.2 * LR)


def test_mixed_sp_matches_jax(runs):
    """The mixed-case step on 2 sp ranks against JAX's single-device mixed
    step on the same batch (`test_sp_fused.py::
    test_mixed_sp_matches_single_device`'s config and limits), and its
    gradients."""
    r = runs["mixed"]
    s_j, m_j, _ = r["jax"]
    _held(r["ranks"][0], s_j, m_j, None, LIMITS["float32"],
          4.4 * MIXED["lr"])


@pytest.mark.parametrize("name", ["f32", "dp2xsp2", "mixed"])
def test_normalizer_matches_jax(runs, name):
    """The normalizer after the sp step: JAX's statistics within 1e-5
    relative."""
    r = runs[name]
    got, j = r["ranks"][0]["norm"], r["jax"][0].norm_state
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(getattr(j, k)),
                                   rtol=1e-5, err_msg=k)
