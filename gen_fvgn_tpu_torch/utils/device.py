"""Device resolution for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. "cuda" without a card raises:
    the port never moves work to the CPU on its own — a caller that wants
    the CPU (the tests) says device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev


def same_device(a, b) -> bool:
    """Whether two devices name the same one: "cuda" (the current card) and
    "cuda:0" do when card 0 is current."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == \
        (current if b.index is None else b.index)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: to a card through pinned memory, without
    waiting for the device."""
    t = torch.from_numpy(np.asarray(a, order="C"))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
