"""PyTorch port, spatial parallelism: `parallel/sp.py`'s cuts of the
statics, the sp applies of `ops/blocksparse.py` at every dispatch route,
and the block train steps (`make_train_step_block`, `MixedTrainStepBlock`
with `sp=True`) on gloo ranks spawned on the CPU (`parallel/launch.py`):
sp = 2 on 2 ranks and dp = 2 x sp = 2 on 4, against the port's
single-process step on the same padded pool. The same steps against the
JAX package's steps are tests/test_torch_sp_jax.py.

Sizes, as the JAX package's `tests/test_parallel.py::
test_block_engine_dp_sp_matches_single_device`: TransFVGN_v2 at hidden 32,
one message-passing block, 8 slices, 4 heads, global batch 8, lr 5e-5,
every entity padded to tile x sp (512 rows at sp 2). The mesh is
`cavity_quad_mesh(20)` (441 nodes, 840 faces, 400 cells), not the JAX
test's `cavity_quad_mesh(5)`: padded to 512 rows, that mesh's 36 nodes,
60 faces and 25 cells all lie on rank 0, and the other rank would hold
padding alone. Here every entity has real rows on both ranks.

Limits, those of the JAX sp tests (`tools/sp_check.compare`): in float32
loss rtol 1e-5 and new states rtol 1e-4 + atol 1e-5
(`tests/test_parallel.py:138`), in bfloat16 loss rtol 1e-4 and states
rtol 1e-3 + atol 1e-3 (`tests/test_sp_fused.py:193`); grad_norm rtol
1e-3, parameters after one step rtol 1e-3 + atol 2.2·lr, the normalizer
1e-5; and the step-1 gradients (Adam's first moment after one step), so
that a stray factor of sp_devices cannot pass: within 1e-3 of the step's
largest gradient element in float32 (measured 2.0e-6 at most), 5e-2 in
bfloat16, whose stream rounds each rank's weight-gradient partial sums to
bfloat16 before the ranks' sum (measured 2.3e-3).
"""

import numpy as np
import pytest
import torch

from torch_port_common import CASE_KW

LR = 5e-5
MESH_N = 20
BASE = dict(net="TransFVGN_v2", batch_size=8, dataset_size=8,
            mxu_dtype="float32", hidden_size=32, message_passing_num=1,
            slice_num=8, attn_heads=4, engine="block", sp_devices=2)
MIXED = dict(BASE, batch_size=4, microbatch=0, norm_global=True,
             lr=2e-3, mixed_case_batches=True)


def _cases(pkg, mixed=False):
    import importlib
    syn = importlib.import_module(f"{pkg}.meshes.synthetic")
    if mixed:       # test_sp_fused.py::test_mixed_sp_matches_single_device
        return [syn.synthetic_case(syn.cavity_quad_mesh(MESH_N), name="quad",
                                   source=1.0, mu=0.1),
                syn.synthetic_case(syn.cavity_tri_mesh(16), name="tri",
                                   source=1.0, mu=0.1)]
    return [syn.synthetic_case(syn.cavity_quad_mesh(MESH_N), **CASE_KW)]


# ---- the cuts of the statics (no ranks) ----

@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("wlsq_rows", ["grad", "full"])
def test_shard_static_sp_reassembles(sp, wlsq_rows):
    """The `sp` row blocks of every operator direction (both directions,
    the composed ones, the take indices, WLSQ's node·n_q rows) and of
    every entity static, stacked in rank order, are the whole pack's,
    exactly; each direction's `col` stays global."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.ops.blocksparse import LinOp
    from gen_fvgn_tpu_torch.parallel.sp import shard_static_sp
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(**dict(BASE, sp_devices=sp, node_agg="composed",
                        edge_gather="composed", wlsq_block_rows=wlsq_rows))
    pool = EnvPool([], cfg, seed=0, cases=_cases("gen_fvgn_tpu_torch"),
                   device="cpu")
    whole = pool.statics[0]
    assert whole.pos.shape[0] % (256 * sp) == 0
    cuts = [shard_static_sp(whole, sp, r) for r in range(sp)]
    ops = whole.ops
    n_q = ops.wlsq_n_q
    assert ops.wlsq.fwd.n_out == whole.pos.shape[0] * n_q
    for name in vars(ops):
        v = getattr(ops, name)
        if isinstance(v, LinOp):
            for d in ("fwd", "bwd"):
                full = getattr(v, d)
                parts = [getattr(getattr(c.ops, name), d) for c in cuts]
                assert all(p.n_in == full.n_in for p in parts), name
                assert sum(p.n_out for p in parts) == full.n_out, name
                assert torch.equal(torch.cat([p.to_dense() for p in parts]),
                                   full.to_dense()), (name, d)
                if full.take_idx is not None:
                    assert torch.equal(
                        torch.cat([p.take_idx for p in parts]),
                        full.take_idx), name
        elif torch.is_tensor(v):
            assert torch.equal(torch.cat([getattr(c.ops, name)
                                          for c in cuts]), v), name
    # shared directions stay shared (gsadj is nbr_s transposed)
    assert cuts[0].ops.gsadj.fwd is cuts[0].ops.nbr_s.bwd
    for f in ("pos", "node_type", "node_mask", "cells_area",
              "edge_pos_feat"):
        assert torch.equal(torch.cat([getattr(c, f) for c in cuts]),
                           getattr(whole, f)), f


def test_odd_rows_raise():
    """A row count that does not divide over the sp ranks raises (the
    pool pads to tile x sp, so a remainder is a fault); so does an sp step
    or run without a process group of dp x sp ranks, and the segment
    engine under sp raises JAX's ValueError."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.parallel.sp import (check_world, entity_rows,
                                                shard_static_sp)
    from gen_fvgn_tpu_torch.training.loop import train
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    assert entity_rows(512, 2, 1) == (256, 512)
    with pytest.raises(ValueError, match="do not divide"):
        entity_rows(510, 4, 0)
    pool = EnvPool([], Config(**dict(BASE, sp_devices=1)), seed=0,
                   cases=_cases("gen_fvgn_tpu_torch"), device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        shard_static_sp(pool.statics[0], 3, 0)
    with pytest.raises(RuntimeError, match="sp_devices=2"):
        check_world(1, 2)
    with pytest.raises(ValueError, match="requires engine='block'"):
        train(Config(**dict(BASE, engine="segment")),
              cases=_cases("gen_fvgn_tpu_torch"), device="cpu")


# ---- the runs: one spawn of 2 ranks, one of 4 ----

SPECS = {"f32": BASE, "bf16": dict(BASE, mxu_dtype="bfloat16"),
         "dp2xsp2": dict(BASE, dp_devices=2), "mixed": MIXED,
         "split": dict(BASE, node_agg="split"),
         "wide": dict(BASE, node_agg="wide"),
         "composed_gather": dict(BASE, edge_gather="composed"),
         "fv_packed_off": dict(BASE, fv_packed=False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spec's step on its ranks (the apply routes and the sp = 2
    specs in one spawn of 2 ranks, dp2 x sp2 in one spawn of 4) and the
    port's single-process step on the same pool, from the same seed."""
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.tools.sp_check import run_steps
    from torch_sp_workers import several
    tmp = tmp_path_factory.mktemp("sp")
    T = "gen_fvgn_tpu_torch"
    specs = {k: dict(cfg=kw, cases=_cases(T, k == "mixed"),
                     mixed=k == "mixed", device="cpu", steps=1, seed=0)
             for k, kw in SPECS.items()}
    routes = dict(cfg=dict(BASE, node_agg="composed",
                           edge_gather="composed"), cases=_cases(T),
                  routes=ROUTES)
    two = [k for k in specs if k != "dp2xsp2"]
    r2 = spawn(several, 2, [("routes", routes)]
               + [("steps", dict(specs[k], ranks=True)) for k in two],
               workdir=str(tmp))
    r4 = spawn(several, 4, [("steps", dict(specs["dp2xsp2"], ranks=True))],
               workdir=str(tmp))
    out = {"routes": [r[0] for r in r2]}
    for i, name in enumerate(two):
        out[name] = dict(ranks=[r[i + 1] for r in r2])
    out["dp2xsp2"] = dict(ranks=[r[0] for r in r4])
    for name, spec in specs.items():
        out[name]["single"] = run_steps(0, 1, dict(spec, ranks=False))
    return out


@pytest.mark.parametrize("name", list(SPECS))
def test_sp_step_matches_the_single_process_step(runs, name):
    """Rank 0 against the port's step at the global batch in one process
    on the same padded pool (`tools/sp_check.compare`, the module's
    limits); every rank holds the same parameter bits and pool; each
    rank's all-reduces are counted."""
    from gen_fvgn_tpu_torch.tools.sp_check import compare
    r = runs[name]
    gaps = compare(r["single"], r["ranks"], SPECS[name].get("lr", LR),
                   steps=1, dtype=SPECS[name]["mxu_dtype"])
    assert gaps["ok"], gaps
    assert r["ranks"][0]["step"] == r["single"]["step"] == 1
    assert all(rk["reduced"][0]["calls"] > 0 for rk in r["ranks"])


@pytest.mark.parametrize("name", ["f32", "dp2xsp2", "mixed"])
def test_global_normalizer_statistics(runs, name):
    """The normalizer after an sp step holds the whole batch's sums over
    every node (one all-reduce of the packed sums over the world): the
    single-process statistics within 1e-6 relative, one accumulation."""
    r = runs[name]
    got, ref = r["ranks"][0]["norm"], r["single"]["norm"]
    assert float(got["num_acc"]) == 2.0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert float(got["acc_count"]) > 1.0 + 4 * 289     # 4 rows of >= 289


ROUTES = [
    ("adj", "linop", 512, 128, "float32"),           # K1's plain version
    ("gather_s", "linop", 512, 128, "float32"),      # the take route
    ("edge_diff", "linop", 512, 12, "float32"),      # csr_matmul
    ("wlsq", "linop", 512, 14, "float32"),           # node·n_q rows
    ("flux_x", "linop", 1024, 6, "float32"),         # faces -> cells
    ("c2n", "linop", 512, 9, "float32"),             # cells -> nodes
    (("scat_r", "scat_s"), "half", 1024, 128, "bfloat16"),
    ("nbr_r", "node_agg", 1024, 128, "bfloat16"),    # composed aggregation
    ("gsadj", "linop", 512, 128, "bfloat16"),        # composed gather
]


def test_sp_applies_match_the_whole_apply(runs):
    """`apply_linop` / `apply_half_agg` / `apply_node_agg` on 2 sp ranks:
    each rank's output rows and operand-gradient rows are those of the
    whole apply in one process on the same operands, the same bits (each
    output row is summed by one rank, in the same order)."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.ops.blocksparse import (apply_half_agg,
                                                    apply_linop,
                                                    apply_node_agg)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(**dict(BASE, node_agg="composed", edge_gather="composed"))
    ops = EnvPool([], cfg, seed=0, cases=_cases("gen_fvgn_tpu_torch"),
                  device="cpu").statics[0].ops
    rng = np.random.default_rng(0)
    ranks = runs["routes"]
    for name, fn, n_in, width, dtype in ROUTES:
        x = torch.from_numpy(rng.normal(size=(2, n_in, width))
                             .astype(np.float32)).to(getattr(torch, dtype))
        x.requires_grad_(True)
        if fn == "half":
            y = apply_half_agg(getattr(ops, name[0]), getattr(ops, name[1]),
                               x)
        elif fn == "node_agg":
            y = apply_node_agg(ops, x)
        else:
            y = apply_linop(getattr(ops, name), x)
        g = rng.normal(size=tuple(y.shape))
        y.backward(torch.from_numpy(g.astype(np.float32)).to(y.dtype))
        key = name if isinstance(name, str) else "+".join(name)
        yf, dx = y.detach().float().numpy(), x.grad.float().numpy()
        for r in ranks:
            (lo, hi), (ylo, yhi) = r[key]["rows"], r[key]["out_rows"]
            assert np.array_equal(r[key]["y"], yf[:, ylo:yhi]), key
            assert np.array_equal(r[key]["dx"], dx[:, lo:hi]), key
