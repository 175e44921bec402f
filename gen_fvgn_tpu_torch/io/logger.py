"""Run directories, the CSV loss monitor, code snapshots and TensorBoard.

Counterpart of `gen_fvgn_tpu/io/logger.py` (`RunLogger` :26-95,
`hyperparam_tag`): the run directory `<base>/<hyperparam tag>/<stamp>/`
with `states/` (checkpoints) and `traing_results/` (the reference's
spelling, kept), `config.json`, `seed.txt`, a snapshot of the port's
source, and `Loss_monitor.dat` in Tecplot `Variables=` CSV form, byte for
byte the JAX logger's for the same scalars. With `use_tensorboard` the
scalars also go to an event file under `tb/` (io/tb_events.py), with value
histograms (`log_histogram`) and the parameter histogram
(`log_param_histogram`).
"""

from __future__ import annotations

import datetime
import os
import shutil
from typing import Dict, List, Optional

import torch

from gen_fvgn_tpu_torch.config import Config


def hyperparam_tag(cfg: Config) -> str:
    return f"net {cfg.net}; hs {cfg.hidden_size};"


class RunLogger:
    def __init__(self, base_dir: str, cfg: Config, copy_code: bool = True,
                 seed: Optional[int] = None, run_name: Optional[str] = None,
                 use_tensorboard: bool = False):
        self.cfg = cfg
        stamp = run_name or datetime.datetime.now().strftime(
            "%Y-%m-%d-%H-%M-%S")
        self.run_dir = os.path.join(base_dir, hyperparam_tag(cfg), stamp)
        self.states_dir = os.path.join(self.run_dir, "states")
        self.results_dir = os.path.join(self.run_dir, "traing_results")
        os.makedirs(self.states_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)

        self._tb = None
        if use_tensorboard:
            from gen_fvgn_tpu_torch.io.tb_events import EventWriter
            self._tb = EventWriter(os.path.join(self.run_dir, "tb"))

        with open(os.path.join(self.run_dir, "config.json"), "wt") as f:
            f.write(cfg.to_json())
        if seed is not None:
            with open(os.path.join(self.run_dir, "seed.txt"), "wt") as f:
                f.write(str(seed))
        if copy_code:
            self._snapshot_code()

        self._loss_path = os.path.join(self.run_dir, "Loss_monitor.dat")
        self._columns: List[str] = []

    def _snapshot_code(self) -> None:
        """Copy the port's source into the run directory (not the built
        kernel library)."""
        import gen_fvgn_tpu_torch
        src_root = os.path.dirname(os.path.abspath(gen_fvgn_tpu_torch.__file__))
        dst = os.path.join(self.run_dir, "code_snapshot", "gen_fvgn_tpu_torch")
        shutil.copytree(src_root, dst,
                        ignore=shutil.ignore_patterns("__pycache__", "_build"),
                        dirs_exist_ok=True)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        """One row of `Loss_monitor.dat`: `step` then the scalars in sorted
        order, each `%.9e`; a new `Variables=` header when the columns
        change."""
        cols = ["step"] + sorted(scalars.keys())
        if cols != self._columns:
            self._columns = cols
            header = "Variables=" + ",".join(f'"{c}"' for c in cols)
            mode = "at" if os.path.exists(self._loss_path) else "wt"
            with open(self._loss_path, mode) as f:
                f.write(header + "\n")
        row = [float(step)] + [float(scalars[k]) for k in sorted(scalars)]
        with open(self._loss_path, "at") as f:
            f.write(",".join(f"{v:.9e}" for v in row) + "\n")
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(key, float(value), step)

    def log_histogram(self, tag: str, values, step: int) -> None:
        """A value histogram to TensorBoard; nothing without
        use_tensorboard."""
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def log_param_histogram(self, module, step: int,
                            tag: str = "params") -> None:
        """One histogram of every parameter of `module`, flattened in the
        order of the JAX package's parameter tree (flax paths sorted), as
        float32; nothing without use_tensorboard."""
        if self._tb is None:
            return
        named = sorted(module.named_parameters(),
                       key=lambda kv: kv[0].replace(".", "/"))
        flat = torch.cat([p.detach().reshape(-1).to(torch.float32)
                          for _, p in named])
        self._tb.add_histogram(tag, flat.cpu().numpy(), step)

    def close(self) -> None:
        """Close the TensorBoard event file, if there is one."""
        if self._tb is not None:
            self._tb.close()
