"""PyTorch port, the training run under spatial parallelism: `train()`
with sp_devices=2 on 2 gloo ranks and with dp_devices=2 x sp_devices=2 on
4, spawned on the CPU, against the JAX package's unsharded `train()` of
the same Config; what each rank writes and holds. The CLIs under sp are
tests/test_torch_sp_cli.py.

Sizes, as tests/test_torch_dp_loop.py (TransFVGN_v2 at hidden 32, one
message-passing block, 8 slices, 4 heads, float32, batch 8, 2 epochs of 2
inner steps, a boundary-condition re-roll after epoch 1), on two cavities
whose real rows span both sp ranks (`cavity_quad_mesh(20)` and
`cavity_quad_mesh(17)`, 8 environments each; the port pads every
entity to tile x 2 = 512 rows, the JAX run to the tile, 256: padded rows
do not enter the results).
Both sides start from the JAX initialisation (the port's through
`resume_from`). Parameters are held to rtol 1e-3 + atol 5·lr, the JAX
loop test's limits.
"""

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
          average_sequence_length=16, export_on_reset=True)
GRIDS = {"sp2": dict(sp_devices=2), "dp2xsp2": dict(dp_devices=2,
                                                    sp_devices=2)}


def _cases(pkg):
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    return [syn.synthetic_case(syn.cavity_quad_mesh(20), **CASE_KW),
            syn.synthetic_case(syn.cavity_quad_mesh(17),
                               **dict(CASE_KW, mu=0.1))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run in this process while the port's runs go on spawned
    ranks in a thread (2 ranks for sp2, 4 for dp2 x sp2), all from the
    JAX initialisation."""
    import threading

    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu.training.loop import train as jtrain
    from gen_fvgn_tpu.training.pool import EnvPool as JPool
    from gen_fvgn_tpu.training.train_block import \
        init_train_state_block as jinit
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.io.checkpoint import save_state
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.training.train_block import \
        init_train_state_block
    from torch_dp_workers import train_runs
    tmp = tmp_path_factory.mktemp("sp_loop")
    jcfg = JConfig(**KW)
    pool = JPool([], jcfg, seed=0, cases=_cases("gen_fvgn_tpu"),
                 engine="block")
    ci, idxs = pool.block_batches(step_seed=0)[0]
    jstate, _ = jinit(jcfg.replace(dataset_size=len(pool)),
                      pool.gather_block(idxs), pool.statics[ci], seed=0)
    state, sim = init_train_state_block(Config(**KW), seed=5, device="cpu")
    sim.load_state_dict(params_from_flax(to_plain_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))))
    start = str(tmp / "start.state")
    save_state(state, start)
    port = {}

    def ranks():
        try:
            for grid, change in GRIDS.items():
                kw = dict(cfg=Config(**dict(KW, **change)),
                          cases=_cases("gen_fvgn_tpu_torch"),
                          log_base_dir=str(tmp / f"port_{grid}"), seed=0,
                          n_epochs=2, resume_from=start)
                n = change.get("dp_devices", 1) * change["sp_devices"]
                port[grid] = [r[0] for r in spawn(train_runs, n, [kw],
                                                  workdir=str(tmp))]
        except BaseException as exc:     # raised below, in the fixture
            port["error"] = exc
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        jrun = jtrain(jcfg, cases=_cases("gen_fvgn_tpu"),
                      log_base_dir=str(tmp / "jax"), seed=0, n_epochs=2)
    finally:
        thread.join()
    if "error" in port:
        raise port["error"]
    return {grid: dict(jax=jrun, ranks=port[grid],
                       base=str(tmp / f"port_{grid}")) for grid in GRIDS}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_sp_train_matches_jax(runs, grid):
    """2 epochs under sp: the same steps and epochs as the JAX run, and
    every parameter within rtol 1e-3 + atol 5·lr of it."""
    from torch_port_common import jax_flat
    r = runs[grid]
    got = r["ranks"][0]
    assert got["epoch"] == int(r["jax"].epoch) == 2
    assert got["step"] == int(r["jax"].step) == 2 * 2 * 2
    jp = jax_flat(r["jax"].params)
    assert set(jp) == set(got["params"])
    for k, v in jp.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-3,
                                   atol=5 * LR, err_msg=k)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_sp_train_ranks_agree_after_a_reroll(runs, grid):
    """Every rank ends with the same parameter bits and the same whole
    pool (boundary conditions, ages, age order, states), after the
    re-roll of epoch 1: every rank pays back the global batch's states."""
    r0, *rest = runs[grid]["ranks"]
    assert r0["age_order"] != list(range(16))       # the re-roll happened
    for r in rest:
        assert all(np.array_equal(r0["params"][k], r["params"][k])
                   for k in r0["params"])
        assert r0["thetas"] == r["thetas"] and r0["ages"] == r["ages"]
        assert r0["age_order"] == r["age_order"]
        for ci in r0["pools"]:
            assert np.array_equal(r0["pools"][ci], r["pools"][ci])
            assert r0["pools"][ci].shape[1] == 512


@pytest.mark.parametrize("grid", list(GRIDS))
def test_sp_train_writes_on_rank_0_only(runs, grid):
    """One run directory for all the ranks, with the loss monitor (a row
    an epoch), the checkpoint slots 0 and 1 and the re-roll's export."""
    r = runs[grid]
    run_dir, = r["ranks"][0]["run_dirs"]
    assert all(x["run_dirs"] == [run_dir] for x in r["ranks"])
    assert sorted(os.listdir(os.path.join(run_dir, "states"))) == \
        ["0.state", "1.state"]
    rows = open(os.path.join(run_dir, "Loss_monitor.dat")).read() \
        .strip().splitlines()[1:]
    assert len(rows) == 2
    assert os.listdir(os.path.join(run_dir, "traing_results"))
