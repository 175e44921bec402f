"""Converts a flax parameter tree (as nested dicts of NumPy arrays) into a
state_dict of the port's block simulators (`FVGNSimulatorB`,
`TransFVGNv1B`, `TransFVGNv2B`), and NumPy normalizer statistics into a
`NormalizerState`.

The port's modules keep the flax layout (`kernel` stored [in, out], names
`hidden_{0,1}`, `out`, `ln`, the Transolver's `attn`, `ln_2`, `mlp_pre`,
`mlp_post`, `graph_temperature` of shape [1, H, 1], bias-less `to_q`/`to_k`/
`to_v`, and the nesting `processor_{i}.gn_{j}`), so the conversion is a
renaming: the path `params/processor_0/transolver/attn/to_q/kernel` becomes
the key `processor_0.transolver.attn.to_q.kernel`. Only NumPy arrays come
in; the caller (a test, or a checkpoint reader of a later slice) makes them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
from gen_fvgn_tpu_torch.utils.device import resolve_device


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            _flatten(val, name, out)
        else:
            out[name] = np.asarray(val)


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """tree: the flax variables ({"params": {...}}) or the params subtree,
    every leaf a NumPy array. Returns a state_dict for the simulator's
    `load_state_dict` (float32 tensors on the host)."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def normalizer_from_numpy(acc_sum, acc_sum_sq, acc_count, num_acc,
                          device="cuda") -> NormalizerState:
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return NormalizerState(acc_sum=t(acc_sum), acc_sum_sq=t(acc_sum_sq),
                           acc_count=t(acc_count), num_acc=t(num_acc))
