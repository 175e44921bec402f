"""The two kinds of cell: training steps and rollout requests.

Both build the system as its users do: a case directory on disk (the
benchmark's own writer), the system's `EnvPool` over it (which reads it
through `load_case`), the system's simulator and step with the
benchmark's weights. The program is looked up through its modules at call
time, so that a test can put a faulty step in its place.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import case, weights
from benchmark.harness.spec import Cell
from benchmark.reference import mesh as rmesh
from benchmark.reference import physics


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def node_order(prog_pos: np.ndarray, raw_pos: np.ndarray) -> np.ndarray:
    """order[i]: the raw node at the program's node i, matched by
    position (the block engine renumbers the nodes)."""
    key = lambda p: np.lexsort((p[:, 0], p[:, 1]))
    po, ro = key(prog_pos), key(raw_pos)
    if not np.allclose(prog_pos[po], raw_pos[ro], atol=1e-9):
        raise RuntimeError("the program's nodes are not the mesh's nodes")
    order = np.empty(prog_pos.shape[0], np.int64)
    order[po] = ro
    return order


class Common:
    """What both kinds share: the case on disk, the pool, the weights,
    and what the check needs of the raw mesh and the environments."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        tr = cell.traffic
        self.mode, self.engine = tr["mode"], tr["engine"]
        self.batch, self.dataset = int(tr["batch"]), int(tr["dataset"])
        tmp = os.environ.get("TMPDIR")
        if not tmp:
            raise RuntimeError("TMPDIR is not set: the case is written "
                               "under the run's own TMPDIR, never a shared "
                               "fixed path")
        self.workdir = os.path.join(tmp, f"gfvgn-benchmark-{cell.name}-{seed}")

    def build(self) -> None:
        from gen_fvgn_tpu_torch.config import Config
        from gen_fvgn_tpu_torch.training import pool as pool_mod
        tr = self.cell.traffic
        self.raw = rmesh.cavity(int(tr["mesh"]["n"]))
        case_dir = case.write_case(os.path.join(self.workdir, "cavity"),
                                   self.raw, self.cell.config["assumed"]["bc"])
        fields = dict(self.cell.cfg, engine=self.engine,
                      batch_size=self.batch, dataset_size=self.dataset)
        self.cfg = Config.from_json(json.dumps(fields))
        t0 = time.perf_counter()
        self.pool = pool_mod.EnvPool(
            [case_dir], self.cfg, seed=self.seed, dataset_size=self.dataset,
            engine=self.engine, tile=self.cfg.tile, device=self.dev)
        self.statics_s = time.perf_counter() - t0
        m = self.pool.cases[0]["mesh"]
        self.prog_pos = np.asarray(m["node|pos"], np.float64)
        self.prog_centroid = np.asarray(m["cell|centroid"], np.float64)
        self.combos = [dict(u=e.theta_sample.mean_u, rho=e.theta_sample.rho,
                            mu=e.theta_sample.mu,
                            source=e.theta_sample.source,
                            aoa=e.theta_sample.aoa, dt=e.theta_sample.dt,
                            L=e.theta_sample.L) for e in self.pool.envs]
        self.weights0 = weights.draw(self.cell.cfg, self.seed, self.dev)

    def load_weights(self, sim) -> None:
        """The benchmark's weights into the program's parameters (copies:
        `weights0` keeps the start for the reference)."""
        with torch.no_grad():
            for name, p in sim.named_parameters():
                p.copy_(self.weights0[name])

    def reference_inputs(self):
        """The raw mesh in the program's node numbering, its statics, and
        the physics of every environment (the reference's own)."""
        order = node_order(self.prog_pos, self.raw.pos)
        st = rmesh.statics(self.raw.renumber(order))
        bc = self.cell.config["assumed"]["bc"]
        coef = dict(bc["theta_PDE"], sigma=bc["sigma"])
        envs = [physics.env_physics(coef, c, st.node_type)
                for c in self.combos]
        return st, envs

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("pool", "sim", "state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def cleanup(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


class Train(Common):
    """Training steps as the system's loop runs them: a permutation of the
    pool cut into batches (`batch_indices` / `block_batches`), each batch
    gathered on the device and fed to the step, the new states paid back
    on every `payback_every`-th pass over the pool."""

    def setup(self) -> None:
        from gen_fvgn_tpu_torch.training import train as tmod
        from gen_fvgn_tpu_torch.training import train_block as bmod
        self.build()
        block = self.engine == "block"
        init = bmod.init_train_state_block if block else tmod.init_train_state
        self.state, self.sim = init(self.cfg, seed=self.seed, device=self.dev)
        self.load_weights(self.sim)
        make = bmod.make_train_step_block if block else tmod.make_train_step
        self.step = make(self.cfg, self.sim, device=self.dev)
        self.iteration, self.queue = 0, []
        self.spans: List[float] = []
        self.losses: List[torch.Tensor] = []
        self.first: Dict = {"batches": []}
        n_first = len(self._next_pass())
        if n_first < 3:
            raise ValueError("the check follows three steps on distinct "
                             "rows: the pool needs three batches")
        for k in range(n_first):
            self.one_step()
            if k < 3:
                self._record_first(k)
        self.spans.clear()
        self.losses.clear()

    def _next_pass(self):
        self.iteration += 1
        if self.engine == "block":
            self.queue = [idx for _, idx in
                          self.pool.block_batches(step_seed=self.iteration)]
        else:
            self.queue = list(self.pool.batch_indices(
                step_seed=self.iteration))
        return self.queue

    def one_step(self) -> None:
        if not self.queue:
            self._next_pass()
        idxs = self.queue.pop(0)
        payback = self.iteration % int(self.cell.traffic["payback_every"]) \
            == 0 and not self.queue
        if self.engine == "block":
            feed = self.pool.gather_block(idxs)
            t0 = time.perf_counter()
            self.state, metrics, new = self.step(self.state, feed,
                                                 self.pool.statics[0])
            self.spans.append(time.perf_counter() - t0)
            if payback:
                self.pool.payback_block(idxs, new)
        else:
            feed = self.pool.gather_batch(idxs)
            t0 = time.perf_counter()
            self.state, metrics, new = self.step(self.state, feed)
            self.spans.append(time.perf_counter() - t0)
            if payback:
                self.pool.payback(idxs, new)
        self.losses.append(metrics.loss)
        self.last_idxs, self.last_new = np.asarray(idxs), new

    def _record_first(self, k: int) -> None:
        f = self.first
        f["batches"].append(self.last_idxs.tolist())
        f.setdefault("loss", []).append(float(self.losses[-1]))
        named = list(self.sim.named_parameters())
        if k == 0:
            # the first step's new node states, as the pool's payback
            # gets them: [B, Np, 3], dimensional
            f["node1"] = self.last_new.float().cpu().numpy()
            # Adam's first moment after one step is (1 - 0.9) g; a step
            # that made no moment has no gradient to show (NaN)
            st = self.state.optimizer.state
            f["grad1"] = {}
            for n, p in named:
                m = st.get(p, {}).get("exp_avg")
                f["grad1"][n] = float("nan") if m is None else float(
                    (m / (1 - 0.9)).double().norm())
        if k == 2:
            f["change"] = {n: float((p.detach() - self.weights0[n])
                                    .double().norm()) for n, p in named}

    def window(self, seconds: float) -> Dict:
        sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.one_step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.dev)
        t1 = time.perf_counter()
        fin = torch.isfinite(torch.stack(self.losses)).cpu().numpy()
        return {"steps": n, "seconds": t1 - t0, "spans": list(self.spans),
                "failed": int((~fin).sum())}

    def stretch(self, steps: int) -> None:
        for _ in range(steps):
            self.one_step()


class Rollout(Common):
    """Rollout requests: each takes `batch` environments of the pool drawn
    from the seed, from their start, through `rollout_steps` steps of the
    system's `rollout` / `rollout_block`, every step's record on the host
    through the export callback, as the `solve` CLI receives it."""

    def setup(self) -> None:
        from gen_fvgn_tpu_torch.models import simulator as smod
        from gen_fvgn_tpu_torch.models import simulator_block as sbmod
        from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
        self.build()
        make = (sbmod.make_simulator_block if self.engine == "block"
                else smod.make_simulator)
        self.sim = make(self.cfg, device=self.dev, seed=self.seed)
        self.load_weights(self.sim)
        self.sim.eval()
        # the normaliser a run over the whole pool would have gathered:
        # made here from the reference's physics, handed to both sides
        n = self.raw.pos.shape[0]
        bc = self.cell.config["assumed"]["bc"]
        coef = dict(bc["theta_PDE"], sigma=bc["sigma"])
        types = rmesh.node_types(self.raw)
        th = np.stack([physics.env_physics(coef, c, types)["theta"]
                       for c in self.combos])
        self.norm = {"s": n * th.sum(0), "s2": n * (th ** 2).sum(0),
                     "count": 1.0 + n * th.shape[0],
                     "num": 1.0 + th.shape[0]}
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=self.dev)
        self.norm_state = NormalizerState(
            f32(self.norm["s"]), f32(self.norm["s2"]),
            f32(self.norm["count"]), f32(self.norm["num"]))
        self.steps = int(self.cell.traffic["rollout_steps"])
        self.rng = np.random.default_rng([self.seed, 7])
        self.requests: List[Dict] = []
        self.kept: Dict = {}
        self.latencies: List[float] = []
        self.failed = 0
        self.closed = False
        self._request(int(self.cell.traffic["warm_steps"]), keep=False)
        self.requests.clear()
        self.latencies.clear()
        self.failed = 0

    def _new_request(self) -> Dict:
        idxs = self.rng.choice(self.dataset, self.batch, replace=False)
        keep = {0, self.steps - 1} | set(
            int(t) for t in self.rng.integers(1, self.steps - 1, 2))
        req = {"idxs": idxs, "keep": keep, "done": 0}
        self.requests.append(req)
        return req

    def _run(self, feed, n_steps, export):
        from gen_fvgn_tpu_torch.solve import rollout as ro
        from gen_fvgn_tpu_torch.solve import rollout_block as rb
        if self.engine == "block":
            return rb.rollout_block(self.cfg, self.sim, self.norm_state,
                                    feed, self.pool.statics[0], n_steps,
                                    export_fn=export)
        return ro.rollout(self.cfg, self.sim, self.norm_state, feed,
                          n_steps, export_fn=export)

    def _request(self, n_steps: int, keep: bool = True,
                 deadline=None) -> None:
        """One request. Past `deadline` its steps still run to the end,
        so that its answers can be checked, but they are not the
        window's."""
        req = self._new_request()
        prev = [time.perf_counter()]
        idxs = req["idxs"]
        feed = (self.pool.gather_block(idxs) if self.engine == "block"
                else self.pool.gather_batch(idxs))

        def export(t, node, cell, rec):
            now = time.perf_counter()
            req["done"] = t + 1
            if keep and (t in req["keep"] or t + 1 in req["keep"]):
                losses = np.stack([rec[k] for k in (
                    "loss_cont", "loss_mom_x", "loss_mom_y", "loss_press")])
                self.kept[(len(self.requests) - 1, t)] = (node, cell, losses)
            if self.closed:
                return
            self.latencies.append(now - prev[0])
            prev[0] = now
            self.t_last = now
            self.failed += int(not (np.isfinite(node).all()
                                    and np.isfinite(cell).all()))
            if deadline is not None and now >= deadline:
                self.closed = True
        self._run(feed, n_steps, export)

    def window(self, seconds: float) -> Dict:
        sync(self.dev)
        t0 = time.perf_counter()
        self.t_last, self.closed = t0, False
        while not self.closed:
            self._request(self.steps, deadline=t0 + seconds)
        return {"steps": len(self.latencies), "seconds": self.t_last - t0,
                "latencies": list(self.latencies), "failed": self.failed}

    def stretch(self, steps: int) -> None:
        self.closed = True
        self._request(steps, keep=False)
