"""Whether what the timed path produced is right: the numbers compared
with the plain reference, each against its limit.

Training cells: the reference follows the first three steps that set-up
drove through the window's own call, from the same weights and the same
environments (its own statics, physics and start states). The numbers:
the gap of the first step's loss (`loss1_gap`) and the largest gap of the
three steps' losses (`loss_gap`: the later steps inherit Adam's first
update, which is near sign(g) and so follows the rounding of gradient
entries near nought where the batch's samples cancel); the worst
channel's gap of the first step's new node states (as the rollouts'
`node_gap`, below); the median leaf's gap between the norms of the first
gradient (read from Adam's first moment after one step); the
worst leaf's gap between the norms of the parameters' change after three
steps. A leaf's change gap is measured against the larger of the
reference's norm of that leaf and of the median leaf. A leaf's gradient
gap is measured against the larger of its scale and the median leaf's:
the sum over the batch's samples of the norms of their parts of the
gradient. (Against the mean's own norm it swings from seed to seed with
the cancellation between the samples, for the program and the control
alike; the detail lines show it.) Leaves whose reference gradient is
under a thousandth of the median leaf's are left out (they move under
Adam by round-off alone).

Rollout cells: a sample of the finished requests' steps, drawn from the
seed, with a first and a last step among them. The reference takes the
step's input state (its own start state for a first step, else the
program's state of the step before, as exported) and computes the step;
compared: the worst channel's L2 gap of the node states and of the cell
states, in the flow's units, against the norm of the whole state. The
largest gap of a sample's log residual is shown, and compared only
where a cell's limits name it.

Only the numbers that the cell's limits file names are compared.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import model as rmodel
from benchmark.reference import step as rstep


def reference_precision(dev) -> None:
    """float32 products with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _ref_cfg(drv) -> Dict:
    return dict(drv.cell.cfg, dataset_size=drv.dataset)


# ---------------------------------------------------------------- training

def train_reference(drv, st, envs, stream=None) -> Dict:
    cfg = _ref_cfg(drv)
    stt = rstep.statics_tensors(st, drv.dev)
    params = {k: v.detach().clone().float() for k, v in drv.weights0.items()}
    batches = [[envs[i] for i in b] for b in drv.first["batches"]]
    lr = float(np.float32(cfg["lr"]))
    out = rstep.train_steps(params, cfg, stt, batches, lr, stream)
    return {"loss": out["loss"], "node1": out["node1"],
            "scale1": np.stack([envs[i]["uvp_dim"] * envs[i]["sigma"]
                                for i in drv.first["batches"][0]]),
            "grad1": {k: float(v.double().norm())
                      for k, v in out["grad1"].items()},
            "grad1_scale": out["grad1_scale"],
            "change": {k: float((params[k] - drv.weights0[k]).double().norm())
                       for k in params}}


def train_numbers(side: Dict, ref: Dict) -> Dict[str, float]:
    names = list(ref["grad1"])
    rg = np.asarray([ref["grad1"][k] for k in names])
    keep = rg >= 1e-3 * np.median(rg)

    def gaps(key, scale_key=None):
        r = np.asarray([ref[key][k] for k in names])[keep]
        p = np.asarray([side[key][k] for k in names])[keep]
        s = r if scale_key is None else \
            np.asarray([ref[scale_key][k] for k in names])[keep]
        return np.abs(p - r) / np.maximum(s, np.median(s))

    rn = ref["node1"]
    pn = side["node1"][:, :rn.shape[1]]
    # a step that left rows of its batch out has no state to match
    state = (float(np.max(channel_gaps(pn, rn, ref["scale1"])))
             if pn.shape == rn.shape else float("inf"))
    loss = np.abs(np.asarray(side["loss"]) - np.asarray(ref["loss"]))
    return {"loss1_gap": float(loss[0]), "loss_gap": float(np.max(loss)),
            "state_gap": state,
            "grad_gap": float(np.median(gaps("grad1", "grad1_scale"))),
            "change_gap": float(np.max(gaps("change")))}


# ----------------------------------------------------------------- rollout

def rollout_pairs(drv, n: int, seed: int) -> List:
    done = {k for k, r in enumerate(drv.requests) if r["done"] == drv.steps}
    cand = sorted((k, t) for (k, t) in drv.kept
                  if k in done and t in drv.requests[k]["keep"])
    if not cand:
        return []
    rng = np.random.default_rng([seed, 11])
    first = [p for p in cand if p[1] == 0]
    last = [p for p in cand if p[1] == drv.steps - 1]
    pick = []
    for group in (first, last):
        if group:
            pick.append(group[int(rng.integers(len(group)))])
    rest = [p for p in cand if p not in pick]
    if rest and len(pick) < n:
        sel = rng.choice(len(rest), min(n - len(pick), len(rest)),
                         replace=False)
        pick += [rest[i] for i in sorted(sel)]
    return pick


def _log_res(losses: np.ndarray, cfg: Dict) -> np.ndarray:
    """losses [4, B]: cont, mom_x, mom_y, press."""
    tot = (cfg["loss_cont"] * losses[0] + cfg["loss_mom"] * (losses[1]
           + losses[2]) + cfg["loss_press"] * losses[3])
    return np.log(np.maximum(tot, max(cfg["loss_log_floor"], 1e-30)))


def rollout_reference(drv, st, envs, pairs, stream=None) -> Dict:
    """The reference's step at each pair: node [B, N, 3], cell [B, C, 3]
    (the reference's cell order), losses [4, B], and each sample's channel
    scales [B, 3] (U, U, U^2)."""
    cfg = _ref_cfg(drv)
    stt = rstep.statics_tensors(st, drv.dev)
    net = rmodel.Net({k: v.float() for k, v in drv.weights0.items()}, cfg,
                     stream)
    nrm = rstep.Normalizer()
    nrm.s, nrm.s2 = drv.norm["s"], drv.norm["s2"]
    nrm.count, nrm.num = drv.norm["count"], drv.norm["num"]
    mean, std = (torch.as_tensor(a, dtype=torch.float32, device=drv.dev)
                 for a in nrm.mean_std())
    n = st.n_nodes
    out = {}
    with torch.no_grad():
        for k, t in pairs:
            idxs = drv.requests[k]["idxs"]
            nodes, cells, losses = [], [], []
            scale = np.stack([envs[i]["uvp_dim"] * envs[i]["sigma"]
                              for i in idxs])
            for b, i in enumerate(idxs):
                et = rstep.env_tensors(envs[i], drv.dev)
                uvp = et["uvp0"] if t == 0 else torch.as_tensor(
                    drv.kept[(k, t - 1)][0][b, :n], device=drv.dev)
                ls, node, cell = rstep.forward(net, stt, uvp, et, mean, std)
                nodes.append(node.cpu().numpy())
                cells.append(cell.cpu().numpy())
                losses.append([float(ls[x]) for x in
                               ("cont", "mom_x", "mom_y", "press")])
            out[(k, t)] = (np.stack(nodes), np.stack(cells),
                           np.asarray(losses).T, scale)
    return out


def _cell_match(prog_centroid: np.ndarray, ref_centroid: np.ndarray):
    key = lambda p: np.lexsort((p[:, 0], p[:, 1]))
    po, ro = key(prog_centroid), key(ref_centroid)
    if not np.allclose(prog_centroid[po], ref_centroid[ro], atol=1e-9):
        raise RuntimeError("the program's cells are not the mesh's cells")
    return po, ro


def channel_gaps(p: np.ndarray, r: np.ndarray, scale: np.ndarray):
    """Each channel's gap in the flow's own units: the states divided by
    each sample's channel scales (U, U, U^2), then ||p - r|| of the
    channel over ||r|| of the whole state (every channel), over the
    batch's rows. The whole state's norm (the lid moves at 1) is steady
    from seed to seed, where a single channel's norm is not."""
    x, y = p / scale[:, None, :], r / scale[:, None, :]
    num = np.sqrt(((x - y) ** 2).sum(axis=(0, 1)))
    return num / max(float(np.sqrt((y ** 2).sum())), 1e-30)


def own_gaps(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Each channel's ||p - r|| / ||r|| of that channel alone (shown in
    the detail lines, not compared)."""
    num = np.sqrt(((p - r) ** 2).sum(axis=(0, 1)))
    return num / np.maximum(np.sqrt((r ** 2).sum(axis=(0, 1))), 1e-30)


def program_side(drv, st, pairs) -> Dict:
    """The program's exported steps at `pairs`, cut to the mesh's nodes
    and cells, the cells in the reference's order."""
    n, c = st.n_nodes, st.n_cells
    po, ro = _cell_match(drv.prog_centroid[:c], st.centroid)
    out = {}
    for key in pairs:
        node, cell, losses = drv.kept[key]
        ref_cell = np.empty_like(cell[:, :c])
        ref_cell[:, ro] = cell[:, :c][:, po]
        out[key] = (node[:, :n], ref_cell, losses)
    return out


def rollout_numbers(side: Dict, ref: Dict, cfg: Dict) -> Dict[str, float]:
    """side: (node [B, N, 3], cell [B, C, 3], losses [4, B]) at each pair,
    in the reference's order; ref: the same and the channel scales."""
    if not ref:
        nan = float("nan")      # no finished request: nothing shown right
        return {"node_gap": nan, "cell_gap": nan, "loss_gap": nan}
    node = cell = loss = 0.0
    for key, (rn, rc, rl, sc) in ref.items():
        pn, pc, pl = side[key][:3]
        node = max(node, float(np.max(channel_gaps(pn, rn, sc))))
        cell = max(cell, float(np.max(channel_gaps(pc, rc, sc))))
        loss = max(loss, float(np.max(np.abs(_log_res(pl, cfg)
                                             - _log_res(rl, cfg)))))
    return {"node_gap": node, "cell_gap": cell, "loss_gap": loss}


def rollout_details(side: Dict, ref: Dict, cfg: Dict) -> List[str]:
    """One line a compared step: its request and step, each channel's
    node and cell gap (compared), each channel's gap against its own norm
    (not compared), the worst log-residual gap."""
    out = []
    r6 = lambda a: np.round(a, 6).tolist()
    for key, (rn, rc, rl, sc) in sorted(ref.items()):
        pn, pc, pl = side[key][:3]
        lg = float(np.max(np.abs(_log_res(pl, cfg) - _log_res(rl, cfg))))
        out.append(f"request {key[0]} step {key[1]}: node "
                   f"{r6(channel_gaps(pn, rn, sc))} cell "
                   f"{r6(channel_gaps(pc, rc, sc))} own norms node "
                   f"{r6(own_gaps(pn, rn))} cell {r6(own_gaps(pc, rc))} "
                   f"log residual {lg:.6g}")
    return out


def train_details(side: Dict, ref: Dict) -> List[str]:
    """The leaves with the worst gradient and change gaps, and each
    step's losses."""
    names = list(ref["grad1"])
    rg = np.asarray([ref["grad1"][k] for k in names])
    keep = rg >= 1e-3 * np.median(rg)
    out = [f"losses program {side['loss']} reference {ref['loss']}",
           f"leaves compared {int(keep.sum())} of {len(names)}"]
    r = np.asarray([ref["grad1"][k] for k in names])[keep]
    p = np.asarray([side["grad1"][k] for k in names])[keep]
    sc = np.asarray([ref["grad1_scale"][k] for k in names])[keep]
    for what, d in (("own norms", r), ("sample scales", sc)):
        g = np.abs(p - r) / np.maximum(d, np.median(d))
        out.append("grad1 leaf gaps against %s: median %.6g, 90th "
                   "percentile %.6g, worst %.6g"
                   % (what, np.median(g), np.percentile(g, 90), g.max()))
    for key in ("grad1", "change"):
        r = np.asarray([ref[key][k] for k in names])
        p = np.asarray([side[key][k] for k in names])
        gap = np.abs(p - r) / np.maximum(r, np.median(r[keep]))
        gap[~keep] = -1
        i = int(np.nanargmax(gap))
        out.append(f"worst {key} leaf {names[i]}: program {p[i]:.6g} "
                   f"reference {r[i]:.6g} gap {gap[i]:.6g}")
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that `limits` names is there, finite and within."""
    return bool(limits) and all(
        k in numbers and np.isfinite(numbers[k]) and numbers[k] <= v
        for k, v in limits.items())


def compare(drv, cell, seed: int, control: bool = False):
    """After the window, with the program's state freed: the numbers of
    the program against the reference, and with `control` those of the
    reference on a float8 stream (e4m3, one scale a tensor:
    `model.Net(stream="float8")`) in the program's place.
    Returns (mesh statics, numbers, control numbers or None, lines of
    detail)."""
    reference_precision(drv.dev)
    st, envs = drv.reference_inputs()
    cfg = _ref_cfg(drv)
    ctrl = None
    if drv.mode == "train":
        ref = train_reference(drv, st, envs)
        numbers = train_numbers(drv.first, ref)
        details = train_details(drv.first, ref)
        if control:
            low = train_reference(drv, st, envs, "float8")
            ctrl = train_numbers(low, ref)
            details += ["control " + d for d in train_details(low, ref)]
    else:
        pairs = rollout_pairs(drv, int(cell.traffic["check_pairs"]), seed)
        ref = rollout_reference(drv, st, envs, pairs)
        side = program_side(drv, st, pairs)
        numbers = rollout_numbers(side, ref, cfg)
        details = rollout_details(side, ref, cfg)
        if control:
            low = rollout_reference(drv, st, envs, pairs, "float8")
            ctrl = rollout_numbers(low, ref, cfg)
            details += ["control " + d for d in rollout_details(low, ref, cfg)]
    return st, numbers, ctrl, details
