"""PyTorch port, the training run under data parallelism: `train()` with
dp_devices=2 on 2 gloo ranks spawned on the CPU, per-case and mixed-case
batches, against the JAX package's `train(dp_devices=2)` on a 2-device
mesh (the 8 virtual CPU devices of tests/conftest.py); what each rank
writes and holds. The CLI under 2 ranks and the dry run are
tests/test_torch_dp_cli.py.

Sizes, as the JAX package's `tests/test_parallel.py::
test_block_train_loop_honors_dp_devices`: TransFVGN_v2 at hidden 32, one
message-passing block, 8 slices, 4 heads, float32, batch 8, 2 epochs of 2
inner steps, pad_multiple 8; here on two cavities (5x5 and 4x4 nodes, 8
environments each) with a boundary-condition re-roll after epoch 1. Both
sides start from the JAX initialisation (the port's through
`resume_from`). Parameters are held to rtol 1e-3 + atol 5·lr, the JAX
loop test's limits; measured 2.74·lr (per-case batches) and 1.46·lr
(mixed) at most.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax

from torch_port_common import CASE_KW, to_plain_dict
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

LR = 5e-5
KW = dict(net="TransFVGN_v2", batch_size=8, dataset_size=16,
          mxu_dtype="float32", hidden_size=32, message_passing_num=1,
          slice_num=8, attn_heads=4, max_inner_steps=2, engine="block",
          dp_devices=2, average_sequence_length=16, export_on_reset=True)
MODES = {"stratified": False, "mixed": True}


def _cases(pkg):
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    return [syn.synthetic_case(syn.cavity_quad_mesh(5), **CASE_KW),
            syn.synthetic_case(syn.cavity_quad_mesh(4),
                               **dict(CASE_KW, mu=0.1))]


def _jax_init():
    """The JAX block loop's own initialisation on these cases (its
    parameters depend on the seed and the net only)."""
    from gen_fvgn_tpu.config import Config
    from gen_fvgn_tpu.training.pool import EnvPool
    from gen_fvgn_tpu.training.train_block import init_train_state_block
    cfg = Config(**KW)
    pool = EnvPool([], cfg, seed=0, pad_multiple=8,
                   cases=_cases("gen_fvgn_tpu"), engine="block")
    ci, idxs = pool.block_batches(step_seed=0)[0]
    state, _ = init_train_state_block(
        cfg.replace(dataset_size=len(pool)), pool.gather_block(idxs),
        pool.statics[ci], seed=0)
    return state.params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both modes: the JAX run in this process, the port's on 2 spawned
    ranks (one spawn for both), from the same start."""
    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.training.loop import train as jtrain
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.training.train_block import \
        init_train_state_block
    from torch_dp_workers import train_runs
    tmp = tmp_path_factory.mktemp("dp_loop")
    jparams = _jax_init()
    state, sim = init_train_state_block(Config(**KW), seed=5, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(
        jax.tree_util.tree_map(np.asarray, jparams))))
    start = str(tmp / "start.state")
    save_state(state, start)
    port_kw = [dict(cfg=Config(mixed_case_batches=mixed, **KW),
                    cases=_cases("gen_fvgn_tpu_torch"),
                    log_base_dir=str(tmp / f"port_{mode}"), seed=0,
                    n_epochs=2, resume_from=start, pad_multiple=8)
               for mode, mixed in MODES.items()]
    port = spawn(train_runs, 2, port_kw, workdir=str(tmp))
    out = {}
    for i, (mode, mixed) in enumerate(MODES.items()):
        jstate = jtrain(JConfig(mixed_case_batches=mixed, **KW),
                        cases=_cases("gen_fvgn_tpu"),
                        log_base_dir=str(tmp / f"jax_{mode}"), seed=0,
                        n_epochs=2, pad_multiple=8)
        out[mode] = dict(jax=jstate, ranks=[r[i] for r in port],
                         base=str(tmp / f"port_{mode}"))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_train_matches_jax(runs, mode):
    """2 epochs of dp=2 training: the same steps and epochs as the JAX
    run, and every parameter within rtol 1e-3 + atol 5·lr of it."""
    from torch_port_common import jax_flat
    r = runs[mode]
    got = r["ranks"][0]
    assert got["epoch"] == int(r["jax"].epoch) == 2
    assert got["step"] == int(r["jax"].step)
    assert got["step"] == 2 * 2 * 2       # epochs x inner steps x batches
    jp = jax_flat(r["jax"].params)
    assert set(jp) == set(got["params"])
    for k, v in jp.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-3,
                                   atol=5 * LR, err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_train_ranks_agree_after_a_reroll(runs, mode):
    """Both ranks end with the same parameter bits and the same pool: the
    same boundary conditions, ages, age order and states, after the
    re-roll of epoch 1 (every rank draws it from the same RNG, and every
    rank pays back the global batch's states)."""
    r0, r1 = runs[mode]["ranks"]
    assert all(np.array_equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])
    assert r0["thetas"] == r1["thetas"]
    assert r0["ages"] == r1["ages"] and r0["age_order"] == r1["age_order"]
    assert r0["age_order"] != list(range(16))       # the re-roll happened
    assert min(r0["ages"]) == 0 < max(r0["ages"])
    for ci in r0["pools"]:
        assert np.array_equal(r0["pools"][ci], r1["pools"][ci])


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_train_writes_on_rank_0_only(runs, mode):
    """One run directory for the two ranks, with the loss monitor (a row
    an epoch), the checkpoint slots 0 and 1 and the re-roll's export;
    its last slot loads into a fresh state with rank 0's parameters."""
    import torch

    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.convert import flax_paths
    from gen_fvgn_tpu_torch.io.checkpoint import load_state
    from gen_fvgn_tpu_torch.training.train_block import \
        init_train_state_block
    r = runs[mode]
    run_dir, = r["ranks"][0]["run_dirs"]
    assert r["ranks"][1]["run_dirs"] == [run_dir]
    assert sorted(os.listdir(os.path.join(run_dir, "states"))) == \
        ["0.state", "1.state"]
    rows = open(os.path.join(run_dir, "Loss_monitor.dat")).read() \
        .strip().splitlines()[1:]
    assert len(rows) == 2
    assert os.listdir(os.path.join(run_dir, "traing_results"))
    state, sim = init_train_state_block(Config(**KW), seed=7, device="cpu")
    load_state(os.path.join(run_dir, "states", "1.state"), like=state)
    assert state.epoch == 2
    mine = flax_paths({n: p.detach() for n, p in sim.named_parameters()})
    for k, v in r["ranks"][0]["params"].items():
        assert np.array_equal(mine[k], v), k
    assert torch.is_tensor(state.norm_state.acc_sum)
