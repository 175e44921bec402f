"""Microbatch chunking for the solves.

Counterpart of `gen_fvgn_tpu/training/chunking.py`: a batch above
cfg.microbatch runs as sequential chunks of that size, with no rule on
divisibility. The batch is padded with copies of row 0 to a whole number
of chunks; padded rows carry zero loss weight, and per-sample outputs are
cut back to the real rows. Exact, because samples are independent.

Each chunk takes its own `torch.autograd.grad` and the chunks' gradients
are summed, so the peak memory is one chunk's activations (the JAX
package needs a rematerialised scan for that; here each chunk's graph is
freed after its backward). The JAX package's `chunked_loss_fn`, a flat
value-and-gradient closure for L-BFGS, is `_Problem.flat_value_and_grad`
in solve/instance_opt.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch


def _rows(data, start: int, stop: int):
    return dataclasses.replace(data, **{
        f.name: getattr(data, f.name)[start:stop]
        for f in dataclasses.fields(data)})


def pad_rows(data, rem: int):
    """`data` (a dataclass of tensors with a leading batch axis) with `rem`
    copies of row 0 appended to every field."""
    if rem == 0:
        return data
    return dataclasses.replace(data, **{
        f.name: torch.cat([x, x[:1].expand((rem,) + tuple(x.shape[1:]))])
        for f in dataclasses.fields(data)
        for x in (getattr(data, f.name),)})


def chunk_plan(b: int, mb: int) -> Tuple[int, int]:
    """(n_chunks, pad_rows) for batch b at microbatch mb."""
    rem = (-b) % mb
    return (b + rem) // mb, rem


def mean_weights(b: int, rem: int, device=None) -> torch.Tensor:
    """Per-row weights [b + rem]: 1/b on real rows, 0 on pads, so the
    weighted sum over all chunks is the batch mean over the real rows."""
    return torch.cat([torch.full((b,), 1.0 / b, dtype=torch.float32,
                                 device=device),
                      torch.zeros((rem,), dtype=torch.float32,
                                  device=device)])


def chunked_value_and_grad(loss_w: Callable, params: List[torch.Tensor],
                           data, b: int, mb: int):
    """(loss, grads) of the batch-mean loss over `params`, as sequential
    chunks of mb rows, each with its own backward.

    loss_w(data_chunk, weights_chunk) -> (weighted sum loss, outputs) must
    weight its per-sample losses by `weights_chunk` (zero on pad rows)."""
    n_k, rem = chunk_plan(b, mb)
    dev = params[0].device
    w = mean_weights(b, rem, dev).reshape(n_k, mb)
    padded = pad_rows(data, rem)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = [torch.zeros_like(p) for p in params]
    for k in range(n_k):
        with torch.enable_grad():
            lk, _ = loss_w(_rows(padded, k * mb, (k + 1) * mb), w[k])
            gk = torch.autograd.grad(lk, params, allow_unused=True)
        grads = [a if g is None else a + g for a, g in zip(grads, gk)]
        loss = loss + lk.detach()
    return loss, grads


def flat(tensors) -> torch.Tensor:
    """The tensors as one flat float32 vector, in order."""
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])


def write_flat(params: List[torch.Tensor], x: torch.Tensor) -> None:
    """Copy the flat vector x into `params`, in order."""
    with torch.no_grad():
        for p, v in zip(params, x.split([p.numel() for p in params])):
            p.copy_(v.view_as(p))


def chunked_forward(fwd: Callable, data, b: int, mb: int):
    """Forward only, in chunks: fwd(data_chunk) -> a NamedTuple whose tensor
    fields have a leading batch axis. Returns the same NamedTuple with those
    fields concatenated and cut to the real b rows (other fields from the
    first chunk)."""
    n_k, rem = chunk_plan(b, mb)
    padded = pad_rows(data, rem)
    outs = [fwd(_rows(padded, k * mb, (k + 1) * mb)) for k in range(n_k)]
    return type(outs[0])(*[
        torch.cat([getattr(o, name) for o in outs])[:b]
        if isinstance(v, torch.Tensor) else v
        for name, v in outs[0]._asdict().items()])
