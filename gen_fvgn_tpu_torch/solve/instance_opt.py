"""Instance optimisation at inference time, on the block engine.

Counterpart of `gen_fvgn_tpu/solve/instance_opt.py` (`solve_adam_block`,
`solve_lbfgs_block`, with `_batch_size`, `_use_chunks` and
`_final_outputs`, :38-104 and :241-364): for each time step the input
state is frozen and the network's weights are optimised against the FV
residual of that state (Adam for `inner_steps` steps, or `max_iter`
iterations of L-BFGS with optax's zoom line search); the optimised
network's new state then advances time. The normalizer is not
accumulated. Batches above cfg.microbatch run as sequential chunks
(training/chunking.py).

Each solve works on a copy of the caller's simulator and returns it, so
the caller's weights stay as they were (the JAX solves are functional in
their parameters). The segment-engine `solve_adam` / `solve_lbfgs` belong
to a later slice.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.solve.lbfgs import LBFGS
from gen_fvgn_tpu_torch.training.chunking import (chunked_forward,
                                                  chunked_value_and_grad,
                                                  flat, write_flat)
from gen_fvgn_tpu_torch.training.forward import (training_loss,
                                                 training_loss_weighted)
from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
from gen_fvgn_tpu_torch.training.train import make_optimizer
from gen_fvgn_tpu_torch.utils.device import resolve_device, same_device


def _batch_size(dyn: DynamicPack) -> int:
    return dyn.uvp.shape[0]


def _use_chunks(cfg: Config, b: int) -> bool:
    """Batches above the microbatch run as sequential chunks; at or below
    it the unchunked forward runs (the form the JAX tests pin)."""
    return bool(cfg.microbatch) and b > cfg.microbatch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class _Problem:
    """One frozen time step: the simulator `sim`, its parameters, and the
    loss of the batch `dyn` with the kernels (chunked or not)."""

    def __init__(self, cfg, sim, norm_state, dyn, static):
        self.cfg, self.sim, self.norm_state = cfg, sim, norm_state
        self.dyn, self.static = dyn, static
        self.params = list(sim.parameters())
        self.b, self.mb = _batch_size(dyn), cfg.microbatch
        self.chunked = _use_chunks(cfg, self.b)

    def forward(self, dyn):
        return forward_batch_block(self.sim, self.norm_state, dyn,
                                   self.static, self.cfg,
                                   accumulate_normalizer=False)

    def loss_w(self, dk, wk):
        out = self.forward(dk)
        return training_loss_weighted(out, self.cfg, wk), out

    def value_and_grad(self):
        """(batch-mean log loss, gradients of the parameters)."""
        if self.chunked:
            return chunked_value_and_grad(self.loss_w, self.params, self.dyn,
                                          self.b, self.mb)
        with torch.enable_grad():
            loss = training_loss(self.forward(self.dyn), self.cfg)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self.params, grads)]

    def flat_value_and_grad(self) -> Callable:
        """x -> (loss, flat gradient) at the flat parameter vector x, chunked
        or not as `value_and_grad` is: the counterpart of the JAX package's
        `chunked_loss_fn`, for the L-BFGS solve."""
        def fn(x):
            write_flat(self.params, x)
            loss, grads = self.value_and_grad()
            return loss, flat(grads)
        return fn

    def final_outputs(self):
        """The per-sample outputs of the optimised network: the unchunked
        forward, or the chunked one cut to the real rows."""
        with torch.no_grad():
            if not self.chunked:
                return self.forward(self.dyn)
            return chunked_forward(self.forward, self.dyn, self.b, self.mb)


def _copy_for(simulator, dyn, device):
    dev = resolve_device(device)
    if not same_device(dyn.uvp.device, dev):
        raise ValueError(f"the solve was asked to run on {dev}, got a batch "
                         f"on {dyn.uvp.device}")
    return copy.deepcopy(simulator)


def solve_adam_block(cfg: Config, simulator, norm_state: NormalizerState,
                     dyn: DynamicPack, static: StaticPack, n_time_steps: int,
                     inner_steps: Optional[int] = None,
                     lr: Optional[float] = None,
                     export_fn: Optional[Callable] = None, device="cuda"):
    """Instance-optimised time marching: per time step a fresh Adam (optax's
    defaults, `lr` or cfg.lr) takes `inner_steps` (or cfg.max_inner_steps)
    steps on the frozen state. Returns (the optimised copy of `simulator`,
    history), one record a time step with the JAX solve's keys.
    device="cuda" without a card raises."""
    sim = _copy_for(simulator, dyn, device)
    inner_steps = inner_steps or cfg.max_inner_steps
    lr = lr or cfg.lr
    history = []
    for t in range(n_time_steps):
        prob = _Problem(cfg, sim, norm_state, dyn, static)
        opt = make_optimizer(cfg, prob.params)
        for group in opt.param_groups:
            group["lr"] = lr
        losses = []
        for _ in range(inner_steps):
            loss, grads = prob.value_and_grad()
            for p, g in zip(prob.params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(loss)
        out = prob.final_outputs()
        rec = {"step": t, "inner_losses": _host(torch.stack(losses)),
               "loss_cont": _host(out.loss_cont).reshape(-1),
               "loss_mom_x": _host(out.loss_mom_x).reshape(-1),
               "loss_mom_y": _host(out.loss_mom_y).reshape(-1),
               "uvp_node": _host(out.uvp_node_new),
               "uvp_cell": _host(out.uvp_cell_new)}
        history.append(rec)
        if export_fn is not None:
            export_fn(t, rec["uvp_node"], rec["uvp_cell"], rec)
        dyn = dyn.replace(uvp=out.uvp_node_new)
    return sim, history


def solve_lbfgs_block(cfg: Config, simulator, norm_state: NormalizerState,
                      dyn: DynamicPack, static: StaticPack, n_time_steps: int,
                      max_iter: int = 100, memory_size: int = 100,
                      export_fn: Optional[Callable] = None, device="cuda"):
    """L-BFGS instance optimisation: per time step a fresh L-BFGS
    (solve/lbfgs.py, optax.lbfgs's algorithm) runs exactly `max_iter`
    iterations on the frozen state. Returns (the optimised copy of
    `simulator`, history); `inner_losses` holds the value at the start of
    each iteration. device="cuda" without a card raises."""
    sim = _copy_for(simulator, dyn, device)
    history = []
    for t in range(n_time_steps):
        prob = _Problem(cfg, sim, norm_state, dyn, static)
        f = prob.flat_value_and_grad()
        opt = LBFGS(flat(prob.params), memory_size=memory_size)
        values = [opt.step(f) for _ in range(max_iter)]
        write_flat(prob.params, opt.x)
        out = prob.final_outputs()
        rec = {"step": t, "inner_losses": np.asarray(values, np.float32),
               "uvp_node": _host(out.uvp_node_new),
               "uvp_cell": _host(out.uvp_cell_new)}
        history.append(rec)
        if export_fn is not None:
            export_fn(t, rec["uvp_node"], rec["uvp_cell"], rec)
        dyn = dyn.replace(uvp=out.uvp_node_new)
    return sim, history
