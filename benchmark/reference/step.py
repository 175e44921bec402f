"""One time step of the system, a training loss, and Adam, for the plain
reference.

`forward` is the system's step on one graph: the uvp channels standardised
over the graph's nodes, the theta channels by the running normaliser, the
edge features [x_s - x_r, pos_s - pos_r, |pos_s - pos_r|], the network
(which is handed the node inputs, the edge features, the faces and the
nodes' coordinates, unpadded and in the node inputs' order),
the soft clamp tanh(y / 10) * 10, the Dirichlet overwrite (uv on wall,
inflow and corner nodes; p at a pressure point), the IMEX mix of the old
and new velocities, the FV residual and the state scaled back to
dimensional units. The training loss is the batch mean of
log(w_p press + w_c cont + w_m (mom_x + mom_y)).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import fv
from benchmark.reference.mesh import IN_WALL, INFLOW, PRESS_POINT, WALL
from benchmark.reference.model import Net


def statics_tensors(st, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in vars(st).items():
        if isinstance(v, np.ndarray):
            dt = torch.int64 if v.dtype.kind in "iu" else torch.float32
            out[k] = torch.as_tensor(v).to(device=device, dtype=dt)
    return out


class Normalizer:
    """Running mean / std of the theta channels: sums of every node row
    the training steps saw (count starts at 1), capped at `cap` updates;
    a std under 1e-8 reads 1."""

    def __init__(self, n_ch: int = 9, cap: float = 100.0):
        self.s = np.zeros(n_ch)
        self.s2 = np.zeros(n_ch)
        self.count, self.num, self.cap = 1.0, 1.0, cap

    def accumulate(self, thetas: np.ndarray, n_nodes: int) -> None:
        if self.num < self.cap:
            self.s += n_nodes * thetas.sum(0)
            self.s2 += n_nodes * (thetas ** 2).sum(0)
            self.count += n_nodes * thetas.shape[0]
            self.num += 1

    def mean_std(self):
        mean = self.s / max(self.count, 1.0)
        std = np.sqrt(np.maximum(self.s2 / self.count - mean ** 2, 0.0))
        return mean, np.where(std < 1e-8, 1.0, std)


def env_tensors(env: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=device) for k, v in env.items()}


def forward(net: Net, st: Dict[str, torch.Tensor], uvp, env, mean, std):
    """uvp [N, 3] dimensional; env of `env_tensors`; mean, std [9] tensors.
    Returns (losses, node state [N, 3], cell state [C, 3]), the states
    dimensional."""
    n = uvp.shape[0]
    mu = uvp.mean(0)
    sd = torch.sqrt(((uvp - mu) ** 2).mean(0))
    phi = (uvp - mu) / (sd + 1e-8)
    th = ((env["theta"] - mean) / std).expand(n, -1)
    x = torch.cat([phi, th], -1)
    fn = st["face_node"]
    dp = st["pos"][fn[0]] - st["pos"][fn[1]]
    e = torch.cat([x[fn[0]] - x[fn[1]], dp,
                   torch.linalg.vector_norm(dp, dim=-1, keepdim=True)], -1)
    y = torch.tanh(net(x, e, fn, st["pos"]) / 10.0) * 10.0

    nt = st["node_type"]
    dirichlet = torch.isin(nt, torch.as_tensor(
        [WALL, INFLOW, PRESS_POINT, IN_WALL], device=nt.device))[:, None]
    press = (nt == PRESS_POINT)[:, None]

    def pin(v):
        uv = torch.where(dirichlet, env["target_uv"], v[:, 0:2])
        return torch.cat([uv, torch.where(press, torch.zeros_like(v[:, 2:]),
                                          v[:, 2:])], -1)

    y = pin(y)
    uv_old = uvp[:, 0:2] / env["uvp_dim"][0:2]
    uv_hat = 0.5 * (uv_old + y[:, 0:2])
    losses, rt, cell = fv.residual(st, y, uv_hat, uv_old, env)
    scale = env["uvp_dim"] * env["sigma"]
    return losses, pin(rt) * scale, cell * scale


def log_loss(losses, w: Dict[str, float]) -> torch.Tensor:
    tot = (w["loss_press"] * losses["press"] + w["loss_cont"] * losses["cont"]
           + w["loss_mom"] * (losses["mom_x"] + losses["mom_y"]))
    return torch.log(torch.clamp(tot, min=max(w["loss_log_floor"], 1e-30)))


class Adam:
    """torch.optim.Adam's update (β 0.9 / 0.999, eps 1e-8 outside the
    square root, bias-corrected), written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.p, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            self.p[k].sub_(self.lr * mh / (vh.sqrt() + 1e-8))


def train_steps(params, cfg, st, batches: List[List[Dict]], lr: float,
                stream=None) -> Dict:
    """The training steps of the reference from `params` (float32 leaves,
    updated in place): each batch is a list of environments (their
    physics, `env_physics`, with their start state "uvp0"); `stream`: the
    network's stream type (`model.Net`). Returns the
    loss of each step, the gradient of the first step and, of each leaf,
    the sum over the first batch's samples of the norms of their parts of
    it (a scale that the batch mean's cancellation does not shrink), and
    the first step's new node states [B, N, 3] (dimensional); the
    parameters are left as the last step made them."""
    net = Net(params, cfg, stream)
    norm = Normalizer(cap=float(cfg["dataset_size"]))
    opt = Adam(params, lr)
    dev = next(iter(params.values())).device
    out = {"loss": [], "grad1": None, "grad1_scale": None, "node1": None}
    n = st["pos"].shape[0]
    for batch in batches:
        norm.accumulate(np.stack([e["theta"] for e in batch]), n)
        mean, std = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in norm.mean_std())
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        scale = {k: 0.0 for k in params}
        total, nodes = 0.0, []
        for env in batch:
            for v in params.values():
                v.requires_grad_(True)
            et = env_tensors(env, dev)
            losses, node, _ = forward(net, st, et["uvp0"], et, mean, std)
            nodes.append(node.detach().cpu().numpy())
            loss = log_loss(losses, cfg) / len(batch)
            g = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
            for (k, v), gk in zip(params.items(), g):
                if gk is not None:
                    grads[k] += gk
                    scale[k] += float(gk.double().norm())
            total += float(loss.detach())
            for v in params.values():
                v.requires_grad_(False)
        out["loss"].append(total)
        if out["grad1"] is None:
            out["grad1"] = {k: v.clone() for k, v in grads.items()}
            out["grad1_scale"] = scale
            out["node1"] = np.stack(nodes)
        with torch.no_grad():
            opt.step(grads)
    return out
