"""PyTorch port, spatial parallelism from the command line: `pre_train
--sp-devices 2` and `solve --engine block --sp-devices 2` on 2 gloo ranks
spawned on the CPU. Cases: a 21x21-node quad cavity and a 17x17-node
triangle cavity written by `tools/case_files.py` (padded to 512 node rows
a case, so that both ranks hold real rows).

Limits: the rollout's fields on 2 ranks against `--sp-devices 1` within
rtol 1e-4 + atol 1e-5, those of the JAX package's
`tests/test_solve_cli.py::test_solve_cli_sp_devices_matches_unsharded`,
from the initial weights as that test runs it (from the trained
checkpoint of the fixture the second step's pressure differs by up to
6.9e-5: norm_uvp standardises a nearly uniform pressure field by its own
small spread, which the ranks' partial sums move in the last bits); the
Adam and L-BFGS solves, from that checkpoint, the same bits on both
ranks.
"""

import glob
import os

import numpy as np
import pytest

MODES = ("rollout", "adam", "lbfgs")


def _solve_argv(case, mode, out_dir, sp, ckpt=None):
    return ["--case", case, "--engine", "block", "--mode", mode, "--steps",
            "2", "--inner-steps", "2", "--net", "FVGN", "--out-dir", out_dir,
            "--device", "cpu", "--sp-devices", str(sp)] + (
                ["--checkpoint", ckpt] if ckpt else [])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """On 2 ranks: pre_train --sp-devices 2 (per-case batches, then
    mixed-case batches), solve --sp-devices 2 in its three modes from the
    first run's last checkpoint, then pre_train --sp-devices 4 in the
    2-rank group (which raises); in this process the rollout at
    --sp-devices 1."""
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.scripts import solve
    from gen_fvgn_tpu_torch.tools.case_files import write_cavity_case
    from torch_sp_workers import cli_rank
    tmp = tmp_path_factory.mktemp("sp_cli")
    data = str(tmp / "data")
    case = write_cavity_case(os.path.join(data, "quad"), n=20)
    write_cavity_case(os.path.join(data, "tri"), n=16, kind="tri")
    train = ["--dataset-dir", data, "--epochs", "2", "--batch-size", "2",
             "--dataset-size", "4", "--max-inner-steps", "1",
             "--mxu-dtype", "float32", "--net", "FVGN", "--device", "cpu"]
    logs = {m: str(tmp / f"runs_{m}") for m in ("stratified", "mixed")}
    ckpt = os.path.join(logs["stratified"], "*", "*", "states", "1.state")
    jobs = [("pre_train", train + ["--log-dir", logs["stratified"],
                                   "--sp-devices", "2"]),
            ("pre_train", train + ["--log-dir", logs["mixed"],
                                   "--sp-devices", "2",
                                   "--mixed-case-batches", "1"])]
    # the rollout from the initial weights, as the JAX test runs it; the
    # solves from the trained checkpoint
    jobs += [("solve", _solve_argv(case, m, str(tmp / f"{m}_sp2"), 2,
                                   None if m == "rollout" else ckpt))
             for m in MODES]
    ranks = spawn(cli_rank, 2, jobs,
                  train + ["--log-dir", str(tmp / "bad"),
                           "--sp-devices", "4"], workdir=str(tmp))
    single = solve.main(_solve_argv(case, "rollout", str(tmp / "rollout_sp1"),
                                    1))
    return dict(ranks=ranks, logs=logs, single=single, tmp=tmp)


@pytest.mark.parametrize("mode", ["stratified", "mixed"])
def test_pre_train_sp_writes_one_run(runs, mode):
    """`pre_train --sp-devices 2 --device cpu` on 2 ranks: one run
    directory (rank 0's) with the checkpoint slots 0 and 1 and a loss
    monitor row an epoch, with finite losses."""
    log_dir = runs["logs"][mode]
    run_dir, = glob.glob(os.path.join(log_dir, "*", "*"))
    assert sorted(os.listdir(os.path.join(run_dir, "states"))) == \
        ["0.state", "1.state"]
    lines = open(os.path.join(run_dir, "Loss_monitor.dat")).read() \
        .strip().splitlines()
    assert len(lines) == 3
    assert all(np.isfinite([float(v) for v in ln.split(",")]).all()
               for ln in lines[1:])


def test_world_size_other_than_dp_sp_raises(runs):
    """`--sp-devices 4` in a group of 2 ranks raises on each rank before
    any case is read, naming dp_devices x sp_devices and the world size;
    outside any group `--sp-devices 2` raises naming torchrun."""
    from gen_fvgn_tpu_torch.scripts import pre_train
    for _, err in runs["ranks"]:
        assert "dp_devices=1 x sp_devices=4" in err, err
        assert "world size 4" in err and "found 2" in err, err
    assert not os.path.exists(runs["tmp"] / "bad")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        pre_train.main(["--dataset-dir", "nowhere", "--sp-devices", "2",
                        "--device", "cpu"])


def test_solve_sp_rollout_matches_sp1(runs):
    """`solve --engine block --sp-devices 2 --mode rollout`: every time
    step's whole-mesh fields on both ranks against `--sp-devices 1`
    within rtol 1e-4 + atol 1e-5; rank 0 alone wrote the step files."""
    got = [r[0][2] for r in runs["ranks"]]
    ref = runs["single"]
    assert len(got[0]) == len(ref) == 2
    for t, rec in enumerate(ref):
        n = rec["uvp_node"].shape[1]
        for hist in got:
            np.testing.assert_allclose(hist[t]["uvp_node"][:, :n],
                                       rec["uvp_node"], rtol=1e-4,
                                       atol=1e-5)
    assert sorted(os.listdir(runs["tmp"] / "rollout_sp2")) == \
        ["step_00000.dat", "step_00001.dat"]


@pytest.mark.parametrize("mode", MODES)
def test_solve_sp_ranks_agree(runs, mode):
    """Each solve's history (inner losses, residuals, the whole mesh's
    states) is the same bits on both ranks: the losses and gradients are
    all-reduced, so the L-BFGS line searches take the same branches."""
    i = 2 + MODES.index(mode)
    h0, h1 = (r[0][i] for r in runs["ranks"])
    assert len(h0) == len(h1) == 2
    for a, b in zip(h0, h1):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (mode, k)
    assert np.isfinite(h0[-1]["uvp_node"]).all()
