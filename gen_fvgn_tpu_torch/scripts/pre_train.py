"""Data-free training from case directories on disk.

    python -m gen_fvgn_tpu_torch.scripts.pre_train --dataset-dir <dir> \
        [--batch-size 8] [--epochs 210000] [--net TransFVGN_v2] \
        [--device cuda] ...

Counterpart of `scripts/pre_train.py`: the same flags, defaults and
Config, plus `--device` (default "cuda"; "cpu" must be asked for). Every
directory under --dataset-dir that holds a BC.json is a case
(`training/pool.py::load_case`). `--engine` is "block" by default, as in
the JAX script, or "segment" (the Config's default engine). Flags the port
cannot honour yet raise NotImplementedError: `--dp-devices` or
`--sp-devices` above 1, and `--bucket-tiers 1` with `--engine segment`.
`--bucket-tiers` is a segment-engine option: the block engine ignores it,
as in JAX.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--log-dir", default="runs")
    ap.add_argument("--net", default="TransFVGN_v2",
                    choices=["FVGN", "TransFVGN_v1", "TransFVGN_v2"])
    ap.add_argument("--epochs", type=int, default=210_000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--dataset-size", type=int, default=100)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--order", default="2nd",
                    choices=["1st", "2nd", "3rd", "4th"])
    ap.add_argument("--integrator", default="imex",
                    choices=["explicit", "implicit", "imex"])
    ap.add_argument("--conserved-form", type=int, default=1)
    ap.add_argument("--max-inner-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp-devices", type=int, default=1)
    ap.add_argument("--sp-devices", type=int, default=1)
    ap.add_argument("--mxu-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--engine", default="block",
                    choices=["segment", "block"],
                    help="sparse-op engine")
    ap.add_argument("--resume", default=None,
                    help="path to a .state checkpoint slot")
    ap.add_argument("--bucket-tiers", type=int, default=0,
                    help="segment engine: per-size padding tiers")
    ap.add_argument("--export-on-reset", type=int, default=0,
                    help="export retiring env solutions on BC re-roll")
    ap.add_argument("--microbatch", type=int, default=8,
                    help="block engine: gradient-accumulation chunk size "
                    "for larger batches (0 disables)")
    ap.add_argument("--mixed-case-batches", type=int, default=0,
                    help="block engine: sample batches from one global "
                    "permutation across all cases, run as per-case groups")
    ap.add_argument("--tensorboard", type=int, default=0,
                    help="also log to TensorBoard event files")
    ap.add_argument("--device", default="cuda",
                    help="torch device (\"cpu\" only when asked)")
    args = ap.parse_args(argv)

    if args.engine == "segment" and args.bucket_tiers:
        raise NotImplementedError(
            "--bucket-tiers 1: the segment engine's per-size padding tiers "
            "belong to a later slice of the port")
    if args.dp_devices > 1 or args.sp_devices > 1:
        raise NotImplementedError(
            "--dp-devices / --sp-devices above 1: data and spatial "
            "parallelism belong to a later slice of the port")

    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.training import loop

    cfg = Config(
        net=args.net, n_epochs=args.epochs, batch_size=args.batch_size,
        dataset_size=args.dataset_size, lr=args.lr, order=args.order,
        integrator=args.integrator, conserved_form=bool(args.conserved_form),
        max_inner_steps=args.max_inner_steps, dataset_dir=args.dataset_dir,
        dp_devices=args.dp_devices, sp_devices=args.sp_devices,
        mxu_dtype=args.mxu_dtype,
        engine=args.engine, bucket_tiers=bool(args.bucket_tiers),
        export_on_reset=bool(args.export_on_reset),
        microbatch=args.microbatch,
        mixed_case_batches=bool(args.mixed_case_batches))

    case_dirs = sorted(
        {os.path.dirname(os.path.join(sub, f))
         for sub, _, files in os.walk(args.dataset_dir)
         for f in files if f == "BC.json"})
    if not case_dirs:
        raise SystemExit(f"no case dirs with BC.json under {args.dataset_dir}")

    loop.train(cfg, case_dirs=case_dirs, log_base_dir=args.log_dir,
               seed=args.seed, resume_from=args.resume,
               use_tensorboard=bool(args.tensorboard), device=args.device)


if __name__ == "__main__":
    main()
