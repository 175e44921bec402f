"""PyTorch port, data parallelism from the command line: `pre_train
--dp-devices 2` on 2 gloo ranks spawned on the CPU, and the port's
two-process dry run (`gen_fvgn_tpu_torch/scripts/dryrun_multihost.py`).
Cases: two 4x4-node cavities written by `tools/case_files.py`."""

import os


def test_pre_train_cli_on_two_ranks(tmp_path):
    """`pre_train --dp-devices 2 --device cpu` on 2 spawned ranks of a
    gloo group: one run directory with its checkpoints; `--dp-devices 3`
    in the same group raises on each rank, naming the world size."""
    from gen_fvgn_tpu_torch.parallel.launch import spawn
    from gen_fvgn_tpu_torch.tools.case_files import write_cavity_case
    from torch_dp_workers import cli_rank
    data = str(tmp_path / "data")
    write_cavity_case(os.path.join(data, "quad"), n=4)
    write_cavity_case(os.path.join(data, "tri"), n=4, kind="tri")
    log_dir = str(tmp_path / "runs")
    argv = ["--dataset-dir", data, "--log-dir", log_dir, "--epochs", "2",
            "--batch-size", "4", "--dataset-size", "8", "--max-inner-steps",
            "1", "--mxu-dtype", "float32", "--net", "FVGN",
            "--mixed-case-batches", "1", "--device", "cpu"]
    errs = spawn(cli_rank, 2, argv + ["--dp-devices", "2"],
                 argv + ["--dp-devices", "3"], workdir=str(tmp_path))
    for err in errs:
        assert "world size 3" in err and "found 2" in err, err
    run_dir, = [os.path.join(log_dir, a, b) for a in os.listdir(log_dir)
                for b in os.listdir(os.path.join(log_dir, a))]
    assert sorted(os.listdir(os.path.join(run_dir, "states"))) == \
        ["0.state", "1.state"]


def test_dryrun_multihost_exits_0(capsys):
    """The port's two-process dry run: exit 0 and one JSON line that says
    the ranks agree with the single-process step."""
    import json

    from gen_fvgn_tpu_torch.scripts.dryrun_multihost import main
    assert main([]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["ok"] and out["ranks_same_bits"] and out["ranks"] == 2
