"""Checkpoint save and restore of the whole train state.

Counterpart of `gen_fvgn_tpu/io/checkpoint.py` (`save_state`, `load_state`,
`RotatingCheckpointer`, :136-170): the simulator's parameters, the Adam
state (moments and step counts), the normalizer's running statistics and
the `step` / `epoch` counters in one slot, slots rotating as
`epoch % keep`. A slot is one `torch.save` file of host tensors, written
under a temporary name in the same directory and moved into place with
`os.replace`, so a slot is either the old one or the new one, whole.

The restore checks the structure first, as the JAX package's keyed
restore does: a checkpoint of another parameter set (a name or a shape
that differs) raises and loads nothing. The port does not read the JAX
package's checkpoints (orbax directories or pickles of flax trees).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from gen_fvgn_tpu_torch.training.normalizer import NormalizerState

_NORM_FIELDS = ("acc_sum", "acc_sum_sq", "acc_count", "num_acc")
_KEYS = {"simulator", "optimizer", "norm_state", "step", "epoch"}


def _to_host(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_dict(state) -> Dict[str, Any]:
    """The TrainState as one dict of host tensors and numbers."""
    return _to_host({
        "simulator": state.simulator.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "norm_state": {f: getattr(state.norm_state, f) for f in _NORM_FIELDS},
        "step": int(state.step),
        "epoch": int(state.epoch),
    })


def save_state(state, path: str) -> None:
    """Atomic save of a TrainState to `path`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(state_dict(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _mismatches(stored: Dict[str, Any], like) -> list:
    """Every way the stored dict differs in structure from `like`."""
    if set(stored) != _KEYS:
        return [f"keys {sorted(stored)} != {sorted(_KEYS)}"]
    bad = []
    mine = {k: tuple(v.shape) for k, v in like.simulator.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in stored["simulator"].items()}
    for k in sorted(set(mine) | set(theirs)):
        if mine.get(k) != theirs.get(k):
            bad.append(f"parameter {k}: stored {theirs.get(k)}, expected "
                       f"{mine.get(k)}")
    params = [p for g in like.optimizer.param_groups for p in g["params"]]
    groups = stored["optimizer"].get("param_groups", [])
    if [len(g["params"]) for g in groups] != \
            [len(g["params"]) for g in like.optimizer.param_groups]:
        bad.append("optimizer parameter groups differ")
    else:
        for idx, st in stored["optimizer"].get("state", {}).items():
            if not 0 <= int(idx) < len(params):
                bad.append(f"optimizer state for parameter {idx} of "
                           f"{len(params)}")
                continue
            for name in ("exp_avg", "exp_avg_sq"):
                got = tuple(st[name].shape)
                if got != tuple(params[int(idx)].shape):
                    bad.append(f"optimizer {name} of parameter {idx}: stored "
                               f"{got}, expected "
                               f"{tuple(params[int(idx)].shape)}")
    for f in _NORM_FIELDS:
        got = tuple(stored["norm_state"][f].shape)
        want = tuple(getattr(like.norm_state, f).shape)
        if got != want:
            bad.append(f"normalizer {f}: stored {got}, expected {want}")
    return bad


def load_state(path: str, like):
    """Restore the slot at `path` into the TrainState `like`, in place
    (parameters, Adam state, normalizer, step, epoch), on like's devices,
    and return it. Raises ValueError, loading nothing, where the stored
    structure differs from like's."""
    stored = torch.load(path, map_location="cpu", weights_only=True)
    bad = _mismatches(stored, like)
    if bad:
        raise ValueError("checkpoint structure mismatch:\n  "
                         + "\n  ".join(bad))
    like.simulator.load_state_dict(stored["simulator"], strict=True)
    like.optimizer.load_state_dict(stored["optimizer"])
    dev = like.norm_state.acc_sum.device
    like.norm_state = NormalizerState(**{
        f: stored["norm_state"][f].to(dev) for f in _NORM_FIELDS})
    like.step = int(stored["step"])
    like.epoch = int(stored["epoch"])
    return like


class RotatingCheckpointer:
    """`keep`-slot rotating checkpoint (slot = epoch % keep), the
    reference's `index=str(epoch % 3)` policy."""

    def __init__(self, states_dir: str, keep: int = 3):
        self.states_dir = states_dir
        self.keep = keep
        os.makedirs(states_dir, exist_ok=True)

    def save(self, state, epoch: int) -> str:
        path = os.path.join(self.states_dir, f"{epoch % self.keep}.state")
        save_state(state, path)
        return path

    def latest(self) -> Optional[str]:
        entries = [os.path.join(self.states_dir, f)
                   for f in os.listdir(self.states_dir)
                   if f.endswith(".state")]
        if not entries:
            return None
        return max(entries, key=os.path.getmtime)
