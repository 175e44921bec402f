"""Instance optimisation at inference time, on both engines.

Counterpart of `gen_fvgn_tpu/solve/instance_opt.py` (`solve_adam`,
`solve_lbfgs`, `solve_adam_block`, `solve_lbfgs_block`, with `_loss_fn`,
`_batch_size`, `_use_chunks`, `make_adam_chunk`, `make_lbfgs_solver` and
`_final_outputs`): for each time step the input state is frozen and the
network's weights are optimised against the FV residual of that state
(Adam for `inner_steps` steps, or `max_iter` iterations of L-BFGS with
optax's zoom line search); the optimised network's new state then advances
time. The normalizer is not accumulated. Batches above cfg.microbatch run
as sequential chunks (training/chunking.py). The segment engine's Adam
solve may run up to `max_chunks_per_step` chunks of `inner_steps` steps a
time step, stopping early once a chunk's last loss is under
log(cfg.residual_tolerance) (the loss is read on the host after a chunk
only when another chunk may follow).

Each solve works on a copy of the caller's simulator and returns it, so
the caller's weights stay as they were (the JAX solves are functional in
their parameters).

The block solves take spatial parallelism (`sp=True`, at dp 1 and batch
1 as JAX `scripts/solve.py:113-134` runs them): `dyn` and `static` are
the rank's rows of the current sp layout (`parallel/sp.py`), the forward
runs in `parallel.sp.sp_context`, and the gradients are summed over the
ranks with the scale 1/sp_devices. The losses and gradients then hold the
same bits on every rank, so every rank's L-BFGS line search takes the
same branches; the records hold the whole mesh's states.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Optional

import numpy as np
import torch

from gen_fvgn_tpu_torch import ops
from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.parallel import dp as dp_mod
from gen_fvgn_tpu_torch.parallel import sp as sp_mod
from gen_fvgn_tpu_torch.solve.lbfgs import LBFGS
from gen_fvgn_tpu_torch.training.chunking import (chunked_forward,
                                                  chunked_value_and_grad,
                                                  flat, write_flat)
from gen_fvgn_tpu_torch.training.forward import (forward_batch,
                                                 training_loss,
                                                 training_loss_weighted)
from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
from gen_fvgn_tpu_torch.training.train import make_optimizer
from gen_fvgn_tpu_torch.utils.device import resolve_device, same_device


def _batch_size(data) -> int:
    return data.uvp.shape[0]


def _use_chunks(cfg: Config, b: int) -> bool:
    """Batches above the microbatch run as sequential chunks; at or below
    it the unchunked forward runs (the form the JAX tests pin)."""
    return bool(cfg.microbatch) and b > cfg.microbatch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class _Problem:
    """One frozen time step: the simulator `sim`, its parameters, and the
    loss of the batch `data` with the kernels (chunked or not): a stacked
    MeshSample on the segment engine (`static` None), or a DynamicPack of
    the case of `static` on the block engine (the rank's rows of the sp
    layout `lay`, where given). The forward does not accumulate the
    normalizer. Unchunked on the segment engine, every forward runs on the
    batch's kernel lists (`ops.mesh_lists`), built once here; chunked,
    `forward_batch` builds each chunk's."""

    def __init__(self, cfg, sim, norm_state, data, static=None, lay=None):
        self.cfg, self.sim, self.norm_state = cfg, sim, norm_state
        self.dyn, self.static, self.lay = data, static, lay
        self.params = list(sim.parameters())
        self.b, self.mb = _batch_size(data), cfg.microbatch
        self.chunked = _use_chunks(cfg, self.b)
        self.lists = (ops.mesh_lists(data, cfg)
                      if static is None and not self.chunked else None)

    def forward(self, dyn):
        if self.static is None:
            return forward_batch(self.sim, self.norm_state, dyn, self.cfg,
                                 accumulate_normalizer=False,
                                 lists=self.lists)
        with (sp_mod.sp_context(self.lay) if self.lay is not None
              else contextlib.nullcontext()):
            return forward_batch_block(self.sim, self.norm_state, dyn,
                                       self.static, self.cfg,
                                       accumulate_normalizer=False)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """A state of the whole mesh from the rank's rows (sp), as is
        without sp."""
        return t if self.lay is None else sp_mod.all_gather_rows_sp(
            t, self.lay)

    def loss_w(self, dk, wk):
        out = self.forward(dk)
        return training_loss_weighted(out, self.cfg, wk), out

    def value_and_grad(self):
        """(batch-mean log loss, gradients of the parameters); under sp
        the gradients summed over the ranks with the scale 1/sp."""
        if self.chunked:
            loss, grads = chunked_value_and_grad(
                self.loss_w, self.params, self.dyn, self.b, self.mb)
        else:
            with torch.enable_grad():
                loss = training_loss(self.forward(self.dyn), self.cfg)
                grads = torch.autograd.grad(loss, self.params,
                                            allow_unused=True)
            loss = loss.detach()
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self.params, grads)]
        if self.lay is not None:
            grads = dp_mod.all_reduce_grads(grads, 1.0 / self.lay.sp)
        return loss, grads

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


def _copy_for(simulator, data, device):
    dev = resolve_device(device)
    if not same_device(data.uvp.device, dev):
        raise ValueError(f"the solve was asked to run on {dev}, got a batch "
                         f"on {data.uvp.device}")
    return copy.deepcopy(simulator)


def _sp_layout(sp: bool):
    """The current sp layout of an sp solve (dp 1), or None."""
    if not sp:
        return None
    lay = sp_mod.layout()
    if lay.dp != 1:
        raise ValueError(f"an sp solve runs at dp 1, the layout has dp "
                         f"{lay.dp}")
    return lay


def _solve_adam(cfg, simulator, norm_state, data, static, n_time_steps,
                inner_steps, lr, export_fn, max_chunks_per_step, device,
                sp=False):
    sim = _copy_for(simulator, data, device)
    lay = _sp_layout(sp)
    inner_steps = inner_steps or cfg.max_inner_steps
    lr = lr or cfg.lr
    log_tol = np.log(max(cfg.residual_tolerance, 1e-30))
    history = []
    for t in range(n_time_steps):
        prob = _Problem(cfg, sim, norm_state, data, static, lay)
        opt = make_optimizer(cfg, prob.params)
        for group in opt.param_groups:
            group["lr"] = lr
        losses = []
        for k in range(max_chunks_per_step):
            for _ in range(inner_steps):
                loss, grads = prob.value_and_grad()
                for p, g in zip(prob.params, grads):
                    p.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
                losses.append(loss)
            if k == max_chunks_per_step - 1 or float(losses[-1]) < log_tol:
                break
        out = prob.final_outputs()
        rec = {"step": t, "inner_losses": _host(torch.stack(losses)),
               "loss_cont": _host(out.loss_cont).reshape(-1),
               "loss_mom_x": _host(out.loss_mom_x).reshape(-1),
               "loss_mom_y": _host(out.loss_mom_y).reshape(-1),
               "uvp_node": _host(prob.whole(out.uvp_node_new)),
               "uvp_cell": _host(prob.whole(out.uvp_cell_new))}
        history.append(rec)
        if export_fn is not None:
            export_fn(t, rec["uvp_node"], rec["uvp_cell"], rec)
        data = data.replace(uvp=out.uvp_node_new)
    return sim, history


def _solve_lbfgs(cfg, simulator, norm_state, data, static, n_time_steps,
                 max_iter, memory_size, export_fn, device, sp=False):
    sim = _copy_for(simulator, data, device)
    lay = _sp_layout(sp)
    history = []
    for t in range(n_time_steps):
        prob = _Problem(cfg, sim, norm_state, data, static, lay)
        f = prob.flat_value_and_grad()
        opt = LBFGS(flat(prob.params), memory_size=memory_size)
        values = [opt.step(f) for _ in range(max_iter)]
        write_flat(prob.params, opt.x)
        out = prob.final_outputs()
        rec = {"step": t, "inner_losses": np.asarray(values, np.float32),
               "uvp_node": _host(prob.whole(out.uvp_node_new)),
               "uvp_cell": _host(prob.whole(out.uvp_cell_new))}
        history.append(rec)
        if export_fn is not None:
            export_fn(t, rec["uvp_node"], rec["uvp_cell"], rec)
        data = data.replace(uvp=out.uvp_node_new)
    return sim, history


def solve_adam(cfg: Config, simulator, norm_state: NormalizerState, batch,
               n_time_steps: int, inner_steps: Optional[int] = None,
               lr: Optional[float] = None,
               export_fn: Optional[Callable] = None,
               max_chunks_per_step: int = 1, device="cuda"):
    """Instance-optimised time marching on the segment engine: per time
    step a fresh Adam (optax's defaults, `lr` or cfg.lr) takes chunks of
    `inner_steps` (or cfg.max_inner_steps) steps on the frozen stacked
    MeshSample `batch`, at most `max_chunks_per_step` of them, until a
    chunk's last loss is under log(cfg.residual_tolerance). Returns (the
    optimised copy of `simulator`, history), one record a time step with
    the JAX solve's keys. device="cuda" without a card raises."""
    return _solve_adam(cfg, simulator, norm_state, batch,
                       None, n_time_steps, inner_steps, lr,
                       export_fn, max_chunks_per_step, device)


def solve_lbfgs(cfg: Config, simulator, norm_state: NormalizerState, batch,
                n_time_steps: int, max_iter: int = 100,
                memory_size: int = 100,
                export_fn: Optional[Callable] = None, device="cuda"):
    """L-BFGS instance optimisation on the segment engine: per time step a
    fresh L-BFGS (solve/lbfgs.py, optax.lbfgs's algorithm) runs exactly
    `max_iter` iterations on the frozen state. Returns (the optimised copy
    of `simulator`, history); `inner_losses` holds the value at the start
    of each iteration. device="cuda" without a card raises."""
    return _solve_lbfgs(cfg, simulator, norm_state, batch,
                        None, n_time_steps, max_iter,
                        memory_size, export_fn, device)


def solve_adam_block(cfg: Config, simulator, norm_state: NormalizerState,
                     dyn: DynamicPack, static: StaticPack, n_time_steps: int,
                     inner_steps: Optional[int] = None,
                     lr: Optional[float] = None,
                     export_fn: Optional[Callable] = None, device="cuda",
                     sp: bool = False):
    """`solve_adam` on the block engine, one chunk a time step (as the JAX
    `solve_adam_block`): the batch is the stacked DynamicPack `dyn` of the
    case of `static` (with `sp`, the rank's rows: the module's
    docstring)."""
    return _solve_adam(cfg, simulator, norm_state, dyn,
                       static, n_time_steps,
                       inner_steps, lr, export_fn, 1, device, sp)


def solve_lbfgs_block(cfg: Config, simulator, norm_state: NormalizerState,
                      dyn: DynamicPack, static: StaticPack, n_time_steps: int,
                      max_iter: int = 100, memory_size: int = 100,
                      export_fn: Optional[Callable] = None, device="cuda",
                      sp: bool = False):
    """`solve_lbfgs` on the block engine: the batch is the stacked
    DynamicPack `dyn` of the case of `static` (with `sp`, the rank's rows:
    the module's docstring)."""
    return _solve_lbfgs(cfg, simulator, norm_state, dyn,
                        static, n_time_steps, max_iter,
                        memory_size, export_fn, device, sp)
