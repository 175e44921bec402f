"""The segment engine's FV residual (`fv/integrator.py::integrate_residuals`
at order "2nd", conserved form) as a few passes over per-entity lists, on
the kernels of csrc/fv_csr.cu.

Replaces no TPU kernel. The JAX package assembles the residual with XLA
gathers, scatter-adds and a batched product; the port's plain version
(`ops/wlsq.py`, `ops/interp.py`, `ops/segment.py`) does the same in about
300 PyTorch operations a forward and 140 a backward, each [B, E, ...]
intermediate written and read again only to be summed by an atomic
`index_add`, and the folded WLSQ solve as a batched float32 GEMV.

* `build_lists`, once a batch (`ops.mesh_lists`, the engine's one place
  that builds them): the lists, integer-exact, on the device,
  with no host synchronisation. Five families of rows, flattened over the
  batch (see `FvLists`): each cell's slots, each node's slots, each face's
  slots, each node's two-way WLSQ stencil entries and each node's faces;
  masked slots, stencil entries and faces are in no list. Each list is in
  ascending entry order: on the card a counting sort (an integer count per
  row, a scan, a fill, and each row's few entries sorted), on the CPU a
  stable sort; the two give the same lists.
* F1 `wlsq`, a node pass: the node's stencil entries in order, the k x 7
  sums of row·Δφ (row the entry's B row times the node's column scale,
  with the parity signs where the node is the entry's sender, as
  `accumulate_B` builds them), then the gradient rows of the folded solve,
  S[0:2] (the integrator keeps no Hessian): grad [B, N, 7, 2].
* F2 `face`, a face pass: each face's two nodes Taylor-extrapolated to its
  centre (`interp.node_to_face`), their gradients averaged, the boundary
  fix (`_fix_face_flux_bc`), written as one 16-float face record of what
  the cells read: uv_new, p, uv_hat, ∇uv_new, ∇uv_hat.
* F3 `cell`, a cell pass over each cell's slots: node→cell of the new and
  old states, the slot fluxes (continuity, convection c·u⊗u, pressure,
  viscous), the outflow traction, the unsteady and source terms; it writes
  `uvp_cell_new` and each cell's squared residuals; `loss`, a block a
  sample, sums them in a fixed order into the pooled losses [B].
* F4 `smooth`, a node pass: the inverse-distance cell→node average over
  the node's slots (`ncn_smooth`).

Backward, three passes: `cell_bwd` (a cell pass: F4's transpose onto the
cells, then F3's, into a slot-major record of each slot's face cotangent
and a record of each cell's node→cell cotangent), `node_bwd` (a node pass
over the node's faces, each face's slots summed in order and the boundary
fix applied, and over the node's slots: F2's and node→cell's transposes)
and `wlsq_bwd` (a node pass over the stencil entries: F1's transpose, plus
what `node_bwd` gave). So the gradients with respect to `uvp_new` and
`uv_hat` are exact for every loss and for `rt_uvp_new` and
`uvp_cell_new`, as the solves need.

Numbers: float32 throughout; each list summed in ascending entry order,
so two runs give the same bits (the plain version's atomics do not); the
float32 sums run in another order than the plain version's, so results
agree within a few float32 roundings of their scale.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
version of each pass through the same lists (`*_reference`), which the
CPU tests hold against `integrate_residuals`'s plain path. What bounds the
kernels: bytes, and the latency of each row's dependent loads.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from gen_fvgn_tpu_torch.utils.types import NodeType

# incremented once per kernel launch, and nowhere else
LAUNCHES_FV_LISTS = 0       # the counting sort's count, fill and row sort
LAUNCHES_FV_WLSQ = 0
LAUNCHES_FV_FACE = 0
LAUNCHES_FV_CELL = 0
LAUNCHES_FV_LOSS = 0
LAUNCHES_FV_SMOOTH = 0
LAUNCHES_FV_CELL_BWD = 0
LAUNCHES_FV_NODE_BWD = 0
LAUNCHES_FV_WLSQ_BWD = 0

K = 5                   # WLSQ columns at order "2nd"
REC = 16                # floats of a face record and of a slot's cotangent
CELL_REC = 8            # floats of a cell's node→cell cotangent record
# parity of each WLSQ column under d -> -d (ops/wlsq.py::_COLUMN_PARITY)
SIGNS = (-1.0, -1.0, 1.0, 1.0, 1.0)

_INFLOW = int(NodeType.INFLOW)
_WALL = int(NodeType.WALL_BOUNDARY)
_OUTFLOW = int(NodeType.OUTFLOW)


class FvLists(NamedTuple):
    """A batch's lists. Rows, in this order, flattened over the batch:
    cells (b·C + c: its slots), nodes (b·N + n: its slots), faces (b·E + f:
    its slots), nodes (b·N + n: its stencil entries), nodes (b·N + n: its
    faces). Entries: a slot is b·K + i; a stencil entry (b·S + e)·2 + side,
    a face (b·E + f)·2 + side, side 0 where the node is the sender
    (stencil[0], face_node[0]), 1 where it is the receiver."""
    ptr: torch.Tensor       # [rows + 1] int32
    ids: torch.Tensor       # [entries] int32; past ptr[-1] never read
    sizes: Tuple[int, int, int, int, int, int]  # B, N, E, C, K, S

    def offsets(self):
        """The first row of each family, and the rows in all."""
        b, n, e, c, _, _ = self.sizes
        o = [0, b * c]
        for rows in (b * n, b * e, b * n, b * n):
            o.append(o[-1] + rows)
        return o


def _sizes(sample):
    b, n = sample.pos.shape[:2]
    return (b, n, sample.face_node.shape[2], sample.centroid.shape[1],
            sample.cells_node.shape[1], sample.stencil.shape[2])


def _keys(sample):
    """(row, live, id) of every entry of the five families, in entry
    order within each family."""
    b, n, e, c, k, s = _sizes(sample)
    dev, i64 = sample.pos.device, torch.int64
    bi = lambda rows: torch.arange(b, device=dev, dtype=i64)[:, None] * rows
    o = FvLists(None, None, (b, n, e, c, k, s)).offsets()
    slot_live = sample.slot_mask.reshape(-1)
    sten = sample.stencil.to(i64).permute(0, 2, 1)        # [B, S, 2]
    faces = sample.face_node.to(i64).permute(0, 2, 1)     # [B, E, 2]
    rows = [o[0] + (sample.cells_index.to(i64) + bi(c)).reshape(-1),
            o[1] + (sample.cells_node.to(i64) + bi(n)).reshape(-1),
            o[2] + (sample.cells_face.to(i64) + bi(e)).reshape(-1),
            o[3] + (sten + bi(n)[..., None]).reshape(-1),
            o[4] + (faces + bi(n)[..., None]).reshape(-1)]
    live = [slot_live] * 3 + [
        sample.stencil_mask[..., None].expand(b, s, 2).reshape(-1),
        sample.face_mask[..., None].expand(b, e, 2).reshape(-1)]
    ids = [torch.arange(r.shape[0], device=dev, dtype=i64) for r in rows]
    return rows, live, ids, o[-1]


def build_lists_reference(sample) -> FvLists:
    """The lists by a stable sort (the CPU's build, and the yardstick of
    the card's)."""
    rows, live, ids, total = _keys(sample)
    key = torch.cat([torch.where(m, r, total) for r, m in zip(rows, live)])
    order = torch.sort(key, stable=True)[1]
    ptr = torch.searchsorted(key[order], torch.arange(
        total + 1, device=key.device, dtype=key.dtype))
    return FvLists(ptr.to(torch.int32), torch.cat(ids)[order][
        :int(ptr[-1])].to(torch.int32), _sizes(sample))


def build_lists(sample) -> FvLists:
    """The batch's lists on its device (kernels on the card)."""
    b, n, e, c, k, s = sizes = _sizes(sample)
    if 2 * b * max(k, s, e) >= 2 ** 31 - 1 or b * (c + 3 * n + e) >= 2 ** 31:
        raise ValueError(f"a batch of {sizes} exceeds the lists' 32-bit "
                         f"rows")
    if sample.pos.device.type != "cuda":
        return build_lists_reference(sample)
    global LAUNCHES_FV_LISTS
    lib = _lib()
    total = FvLists(None, None, sizes).offsets()[-1]
    dev = sample.pos.device
    counts = torch.zeros(2 * total + 1, dtype=torch.int32, device=dev)
    ptr, cursor = counts[:total + 1], counts[total + 1:]
    entries = 3 * b * k + 2 * b * s + 2 * b * e
    ids = torch.empty(entries, dtype=torch.int32, device=dev)
    mesh = _mesh(sample, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _ok(lib.gfvgn_fv_lists(0, ctypes.addressof(mesh), ptr.data_ptr(),
                           cursor.data_ptr(), ids.data_ptr(), stream),
        "fv_list_count")
    ptr[1:].cumsum_(0)
    _ok(lib.gfvgn_fv_lists(1, ctypes.addressof(mesh), ptr.data_ptr(),
                           cursor.data_ptr(), ids.data_ptr(), stream),
        "fv_list_fill")
    LAUNCHES_FV_LISTS += 3
    return FvLists(ptr, ids, sizes)


# ---- the plain versions through the lists (CPU tensors, and the
# kernels' yardstick) ----

def _walk(lists: FvLists, family: int):
    """For each position j of the family's lists: (the rows, counted from
    the family's first, whose list has a j-th entry; those entries)."""
    o = lists.offsets()
    ptr = lists.ptr[o[family]:o[family + 1] + 1].long()
    start, lens = ptr[:-1], torch.diff(ptr)
    for j in range(int(lens.max()) if lens.numel() else 0):
        rows = torch.nonzero(lens > j).reshape(-1)
        yield rows, lists.ids[start[rows] + j].long()


def _flat(t):
    """[B, M, ...] as [B·M, ...] rows of one dimension."""
    return t.reshape(t.shape[0] * t.shape[1], -1)


class _Geo(NamedTuple):
    """The sample's arrays as flat rows (float32 or int64), for the plain
    versions."""
    pos: torch.Tensor
    face_center: torch.Tensor
    face_area: torch.Tensor
    face_node: torch.Tensor     # [B·E, 2] node rows (flattened)
    face_type: torch.Tensor
    centroid: torch.Tensor
    cells_area: torch.Tensor
    cell_mask: torch.Tensor
    cells_node: torch.Tensor    # node rows
    cells_face: torch.Tensor    # face rows
    cells_index: torch.Tensor   # cell rows
    slot_unv: torch.Tensor
    stencil: torch.Tensor       # [B·S, 2] node rows
    S: torch.Tensor             # [B·N, 2, K]: the gradient rows
    B: torch.Tensor             # [B·S, K]
    cs: torch.Tensor            # [B·N, K]
    target_uv: torch.Tensor
    theta: torch.Tensor         # [B, 9]
    sigma: torch.Tensor
    dt: torch.Tensor
    b_cell: torch.Tensor        # the sample of each cell row


def _geo(sample) -> _Geo:
    b, n, e, c, k, s = _sizes(sample)
    dev, i64 = sample.pos.device, torch.int64
    off = lambda rows: torch.arange(b, device=dev, dtype=i64)[:, None] * rows
    rows = lambda t, r: (t.to(i64) + off(r)).reshape(-1)
    two = lambda t, r: (t.to(i64).permute(0, 2, 1)
                        + off(r)[..., None]).reshape(-1, 2)
    samp = lambda m: torch.arange(b, device=dev).repeat_interleave(m)
    return _Geo(
        _flat(sample.pos), _flat(sample.face_center),
        sample.face_area.reshape(-1), two(sample.face_node, n),
        sample.face_type.reshape(-1).to(i64), _flat(sample.centroid),
        sample.cells_area.reshape(-1), sample.cell_mask.reshape(-1),
        rows(sample.cells_node, n), rows(sample.cells_face, e),
        rows(sample.cells_index, c), _flat(sample.slot_unv),
        two(sample.stencil, n),
        sample.wlsq_S.reshape(b * n, K, K)[:, 0:2, :],
        _flat(sample.wlsq_B), _flat(sample.wlsq_scale),
        _flat(sample.target_uv), sample.theta, sample.sigma,
        sample.dt.reshape(-1), samp(c))


def _signs(like):
    return torch.tensor(SIGNS, dtype=like.dtype, device=like.device)


def _stencil_entry(g: _Geo, rows, ids):
    """For entries of the node rows `rows`: the entry's B row, the other
    node's row, and whether `rows` is the entry's sender."""
    side, es = ids & 1, ids >> 1
    other = torch.where(side == 0, g.stencil[es, 1], g.stencil[es, 0])
    return g.B[es], other, side == 0


def _row(g: _Geo, brow, node, sender):
    """The accumulation row of an entry at `node`: B times the node's column
    scale, times the parity signs where the node is the sender."""
    brow = torch.where(sender[:, None], brow * _signs(brow), brow)
    return brow * g.cs[node]


def wlsq_reference(lists, g: _Geo, phi):
    """F1: phi [B·N, 7] -> grad [B·N, 7, 2]."""
    acc = phi.new_zeros(phi.shape[0], K, 7)
    for rows, ids in _walk(lists, 3):
        brow, other, sender = _stencil_entry(g, rows, ids)
        d = phi[other] - phi[rows]
        acc[rows] += _row(g, brow, rows, sender)[:, :, None] * d[:, None, :]
    grad = phi.new_zeros(phi.shape[0], 7, 2)
    for j in range(2):
        for kk in range(K):
            grad[:, :, j] += g.S[:, j, kk, None] * acc[:, kk, :]
    return grad


def _extrap(phi_n, grad_n, r):
    """phi + r·∇phi for each channel: [M, C], [M, C, 2], [M, 2]."""
    return phi_n + (r[:, None, 0] * grad_n[..., 0]
                    + r[:, None, 1] * grad_n[..., 1])


def face_reference(g: _Geo, phi, grad):
    """F2: the face records [B·E, 16]."""
    a, c = g.face_node[:, 0], g.face_node[:, 1]
    va = _extrap(phi[a, 0:5], grad[a, 0:5], g.face_center - g.pos[a])
    vc = _extrap(phi[c, 0:5], grad[c, 0:5], g.face_center - g.pos[c])
    val = 0.5 * (va + vc)
    nab = 0.5 * (grad[a, 0:5] + grad[c, 0:5])
    y = 0.5 * (g.target_uv[a] + g.target_uv[c])
    inflow = (g.face_type == _INFLOW)[:, None]
    wall = (g.face_type == _WALL)[:, None]
    fix = lambda uv: torch.where(wall, torch.zeros_like(uv),
                                 torch.where(inflow, y, uv))
    rec = phi.new_zeros(val.shape[0], REC)
    rec[:, 0:2] = fix(val[:, 0:2])
    rec[:, 2] = val[:, 2]
    rec[:, 3:5] = fix(val[:, 3:5])
    rec[:, 5:9] = nab[:, 0:2].reshape(-1, 4)
    rec[:, 9:13] = nab[:, 3:5].reshape(-1, 4)
    return rec


def _coefs(g: _Geo, b):
    t = g.theta[b]
    return dict(unsteady=t[:, 0], cont=t[:, 1], conv=t[:, 2], gradp=t[:, 3],
                diff=t[:, 4], source=t[:, 5])


_CELL_CH = (0, 1, 2, 5, 6)      # the channels the cells read (conserved)


def _slot(g: _Geo, rec, slots):
    """A slot's node, face record, surface vector and outflow flag."""
    node, face = g.cells_node[slots], g.cells_face[slots]
    sv = g.slot_unv[slots] * g.face_area[face][:, None]
    out = (g.face_type[face] == _OUTFLOW).to(sv.dtype)
    return node, rec[face], sv, out


def _fluxes(rec, sv, out, co):
    """A slot's continuity, momentum flux [M, 2] and outflow residual
    [M, 2]."""
    uvn, p, uh = rec[:, 0:2], rec[:, 2], rec[:, 3:5]
    gn, gh = rec[:, 5:9].reshape(-1, 2, 2), rec[:, 9:13].reshape(-1, 2, 2)
    div = uvn[:, 0] * sv[:, 0] + uvn[:, 1] * sv[:, 1]
    conv = (uh[:, :, None] * uh[:, None, :]) * co["conv"][:, None, None]
    eye = torch.eye(2, dtype=rec.dtype, device=rec.device)
    m = (conv + (eye * p[:, None, None]) * co["gradp"][:, None, None]) \
        - gh * co["diff"][:, None, None]
    j = m[..., 0] * sv[:, None, 0] + m[..., 1] * sv[:, None, 1]
    visc = co["diff"][:, None] * (gn[..., 0] * sv[:, None, 0]
                                  + gn[..., 1] * sv[:, None, 1])
    resid = (visc - p[:, None] * sv) * out[:, None]
    return div, j, resid


def _cell_walk(lists, g: _Geo, phi, grad, rec):
    """The sums of each cell's slots: node→cell totals [C', 5], counts,
    divergence, momentum flux and squared outflow residual; and each slot's
    (cell rows, slot ids, resid) for the backward."""
    nc = g.centroid.shape[0]
    tot = phi.new_zeros(nc, len(_CELL_CH))
    cnt, div = phi.new_zeros(nc), phi.new_zeros(nc)
    rhs, psq = phi.new_zeros(nc, 2), phi.new_zeros(nc)
    slots_seen = []
    for rows, slots in _walk(lists, 0):
        node, r, sv, out = _slot(g, rec, slots)
        rc = g.centroid[rows] - g.pos[node]
        tot[rows] += _extrap(phi[node][:, _CELL_CH], grad[node][:, _CELL_CH],
                             rc)
        cnt[rows] += 1.0
        d, j, resid = _fluxes(r, sv, out, _coefs(g, g.b_cell[rows]))
        div[rows] += d
        rhs[rows] += j
        psq[rows] += resid[:, 0] * resid[:, 0] + resid[:, 1] * resid[:, 1]
        slots_seen.append((rows, slots, sv, out, r, resid))
    return tot, cnt, div, rhs, psq, slots_seen


def _cell_state(g: _Geo, tot, cnt, div, rhs):
    """uvp_cell [C', 3], the old state at cells [C', 2], the momentum
    residual [C', 2]."""
    co = _coefs(g, g.b_cell)
    cell = tot / torch.clamp(cnt, min=1.0)[:, None]
    area = g.cells_area[:, None]
    dt = g.dt[g.b_cell][:, None]
    unsteady = ((cell[:, 0:2] - cell[:, 3:5]) / dt) * area
    mom = co["unsteady"][:, None] * unsteady + (
        rhs - co["source"][:, None] * area)
    return cell[:, 0:3], cell[:, 3:5], mom


def cell_reference(lists, g: _Geo, phi, grad, rec):
    """F3 and the loss pass: (uvp_cell [B·C, 3], squared residuals
    [B·C, 4], roots [4, B], losses [4, B])."""
    tot, cnt, div, rhs, psq, _ = _cell_walk(lists, g, phi, grad, rec)
    ucell, _, mom = _cell_state(g, tot, cnt, div, rhs)
    m = g.cell_mask.to(phi.dtype)
    sq = torch.stack([div * div * m, mom[:, 0] * mom[:, 0] * m,
                      mom[:, 1] * mom[:, 1] * m, psq], dim=1)
    b = g.theta.shape[0]
    tot_b = sq.reshape(b, -1, 4).sum(dim=1).T                  # [4, B]
    roots = torch.where(tot_b > 0, torch.sqrt(torch.where(
        tot_b > 0, tot_b, torch.ones_like(tot_b))), torch.zeros_like(tot_b))
    losses = roots * torch.stack([g.theta[:, 1], g.sigma[:, 0],
                                  g.sigma[:, 1], torch.ones_like(g.dt)])
    return ucell, sq, roots, losses


def _smooth_weight(g: _Geo, node, cell):
    r = g.pos[node] - g.centroid[cell]
    dist = torch.sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1])
    return 1.0 / torch.where(dist > 0, dist, torch.ones_like(dist))


def smooth_reference(lists, g: _Geo, ucell):
    """F4: (rt [B·N, 3], den [B·N])."""
    nn_ = g.pos.shape[0]
    num, den = ucell.new_zeros(nn_, 3), ucell.new_zeros(nn_)
    for rows, slots in _walk(lists, 1):
        cell = g.cells_index[slots]
        w = _smooth_weight(g, rows, cell)
        num[rows] += ucell[cell] * w[:, None]
        den[rows] += w
    return num / torch.clamp(den, min=1e-12)[:, None], den


def cell_bwd_reference(lists, g: _Geo, phi, grad, rec, roots, g_loss,
                       g_cell, g_rt, den):
    """F4's and F3's transposes: (slot cotangents [B·K, 16], cell records
    [B·C, 8])."""
    tot, cnt, div, rhs, psq, seen = _cell_walk(lists, g, phi, grad, rec)
    _, _, mom = _cell_state(g, tot, cnt, div, rhs)
    nc = g.centroid.shape[0]
    dcell = phi.new_zeros(nc, 3) if g_cell is None else g_cell.clone()
    if g_rt is not None:
        scaled = g_rt / torch.clamp(den, min=1e-12)[:, None]
        for rows, slots in _walk(lists, 0):
            node = g.cells_node[slots]
            dcell[rows] += _smooth_weight(g, node, rows)[:, None] \
                * scaled[node]
    gl = [phi.new_zeros(g.theta.shape[0]) if t is None else t
          for t in g_loss]
    coef = [g.theta[:, 1], g.sigma[:, 0], g.sigma[:, 1],
            torch.ones_like(g.dt)]
    fac = [torch.where(roots[q] > 0, gl[q] * coef[q] / torch.where(
        roots[q] > 0, roots[q], torch.ones_like(roots[q])),
        torch.zeros_like(roots[q])) for q in range(4)]
    bc = g.b_cell
    m = g.cell_mask.to(phi.dtype)
    ddiv = fac[0][bc] * div * m
    dmom = torch.stack([fac[1][bc] * mom[:, 0] * m,
                        fac[2][bc] * mom[:, 1] * m], dim=1)
    co = _coefs(g, bc)
    du = dmom * (co["unsteady"] * g.cells_area / g.dt[bc])[:, None]
    inv = 1.0 / torch.clamp(cnt, min=1.0)
    crec = phi.new_zeros(nc, CELL_REC)
    crec[:, 0:2] = (dcell[:, 0:2] + du) * inv[:, None]
    crec[:, 2] = dcell[:, 2] * inv
    crec[:, 3:5] = -du * inv[:, None]
    sbuf = phi.new_zeros(g.cells_node.shape[0], REC)
    for rows, slots, sv, out, r, resid in seen:
        c = _coefs(g, g.b_cell[rows])
        dm = dmom[rows][:, :, None] * sv[:, None, :]        # [M, 2, 2]
        uh = r[:, 3:5]
        dres = fac[3][g.b_cell[rows]][:, None] * resid * out[:, None]
        s = sbuf[slots]
        s[:, 0:2] = ddiv[rows][:, None] * sv
        s[:, 3:5] = c["conv"][:, None] * (
            (dm[:, :, 0] * uh[:, None, 0] + dm[:, :, 1] * uh[:, None, 1])
            + (dm[:, 0, :] * uh[:, 0, None] + dm[:, 1, :] * uh[:, 1, None]))
        s[:, 2] = c["gradp"] * (dm[:, 0, 0] + dm[:, 1, 1]) - (
            dres[:, 0] * sv[:, 0] + dres[:, 1] * sv[:, 1])
        s[:, 5:9] = (c["diff"][:, None, None] * dres[:, :, None]
                     * sv[:, None, :]).reshape(-1, 4)
        s[:, 9:13] = (-c["diff"][:, None, None] * dm).reshape(-1, 4)
        sbuf[slots] = s
    return sbuf, crec


def node_bwd_reference(lists, g: _Geo, sbuf, crec):
    """F2's and node→cell's transposes: (dphi [B·N, 7], dgrad [B·N, 7, 2])
    of the direct paths."""
    o = lists.offsets()
    nn_ = g.pos.shape[0]
    dphi, dgrad = sbuf.new_zeros(nn_, 7), sbuf.new_zeros(nn_, 7, 2)
    fptr = lists.ptr[o[2]:o[3] + 1].long()
    for rows, ids in _walk(lists, 4):
        face = ids >> 1
        dface = sbuf.new_zeros(face.shape[0], REC)
        start, lens = fptr[face], fptr[face + 1] - fptr[face]
        for j in range(int(lens.max()) if lens.numel() else 0):
            live = lens > j
            slots = lists.ids[torch.where(live, start + j, 0)].long()
            dface += torch.where(live[:, None], sbuf[slots],
                                 torch.zeros_like(dface))
        ft = g.face_type[face]
        keep = ((ft != _INFLOW) & (ft != _WALL)).to(sbuf.dtype)[:, None]
        dval = torch.cat([dface[:, 0:2] * keep, dface[:, 2:3],
                          dface[:, 3:5] * keep], dim=1)        # [M, 5]
        dnab = sbuf.new_zeros(face.shape[0], 5, 2)
        dnab[:, 0:2] = dface[:, 5:9].reshape(-1, 2, 2)
        dnab[:, 3:5] = dface[:, 9:13].reshape(-1, 2, 2)
        r = g.face_center[face] - g.pos[rows]
        h = 0.5 * dval
        dphi[rows, 0:5] += h
        dgrad[rows, 0:5] += h[:, :, None] * r[:, None, :] + 0.5 * dnab
    for rows, slots in _walk(lists, 1):
        cell = g.cells_index[slots]
        dc = crec[cell, 0:5]
        rc = g.centroid[cell] - g.pos[rows]
        ch = torch.tensor(_CELL_CH, device=rows.device)
        dphi[rows[:, None], ch] += dc
        dgrad[rows[:, None], ch] += dc[:, :, None] \
            * rc[:, None, :]
    return dphi, dgrad


def wlsq_bwd_reference(lists, g: _Geo, dgrad, dphi):
    """F1's transpose plus the direct paths: dphi [B·N, 7]."""
    out = dphi.clone()
    for rows, ids in _walk(lists, 3):
        brow, other, sender = _stencil_entry(g, rows, ids)

        def t(node, snd):
            u = (g.S[node] * _row(g, brow, node, snd)[:, None, :]).sum(-1)
            return u[:, None, 0] * dgrad[node, :, 0] \
                + u[:, None, 1] * dgrad[node, :, 1]
        out[rows] += t(other, ~sender) - t(rows, sender)
    return out


# ---- the launches ----

def _lib():
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    return load_library()


def _ok(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


class _Mesh(ctypes.Structure):
    """csrc/fv_csr.cu's FvMesh: the sample's arrays and the lists."""
    _fields_ = [(f, ctypes.c_int) for f in ("B", "N", "E", "C", "K", "S")] + [
        (f, ctypes.c_void_p) for f in (
            "pos", "face_center", "face_area", "face_node", "face_type",
            "face_mask", "centroid", "cells_area", "cell_mask", "cells_node",
            "cells_face", "cells_index", "slot_mask", "slot_unv", "stencil",
            "stencil_mask", "wlsq_S", "wlsq_B", "wlsq_scale", "target_uv",
            "theta", "sigma", "dt", "ptr", "ids")] + [
        (f, ctypes.c_int) for f in ("inflow", "wall", "outflow")]


class _Data(ctypes.Structure):
    """csrc/fv_csr.cu's FvData: the passes' inputs, records and outputs
    (null where absent)."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "uvp_new", "uv_hat", "uv_old", "grad", "face_rec", "uvp_cell",
        "cell_sq", "roots", "loss0", "loss1", "loss2", "loss3", "rt", "den",
        "g_loss0", "g_loss1", "g_loss2", "g_loss3", "g_cell", "g_rt",
        "slot_buf", "cell_buf", "dphi", "dgrad", "d_new", "d_hat", "d_old")]


_MESH_FIELDS = ("pos", "face_center", "face_area", "face_node", "face_type",
                "face_mask", "centroid", "cells_area", "cell_mask",
                "cells_node", "cells_face", "cells_index", "slot_mask",
                "slot_unv", "stencil", "stencil_mask", "wlsq_S", "wlsq_B",
                "wlsq_scale", "target_uv", "theta", "sigma", "dt")
_INT_FIELDS = ("face_node", "face_type", "cells_node", "cells_face",
               "cells_index", "stencil")
_BOOL_FIELDS = ("face_mask", "cell_mask", "slot_mask", "stencil_mask")


def _mesh(sample, lists: Optional[FvLists]) -> _Mesh:
    """The FvMesh of a batch on the card; every array contiguous and in the
    kernels' type, else this raises."""
    m = _Mesh(*_sizes(sample))
    for f in _MESH_FIELDS:
        t = getattr(sample, f)
        want = (torch.int32 if f in _INT_FIELDS else torch.bool
                if f in _BOOL_FIELDS else torch.float32)
        if t.dtype != want or not t.is_contiguous() or t.device.type != "cuda":
            raise TypeError(f"fv_csr: {f} must be a contiguous {want} CUDA "
                            f"tensor, got {t.dtype} on {t.device}")
        setattr(m, f, t.data_ptr())
    if lists is not None:
        m.ptr, m.ids = lists.ptr.data_ptr(), lists.ids.data_ptr()
    m.inflow, m.wall, m.outflow = _INFLOW, _WALL, _OUTFLOW
    return m


# pass ids of gfvgn_fv_pass
WLSQ, FACE, CELL, SMOOTH, CELL_BWD, NODE_BWD, WLSQ_BWD = range(7)
_PASS_NAMES = ("fv_wlsq", "fv_face", "fv_cell", "fv_smooth", "fv_cell_bwd",
               "fv_node_bwd", "fv_wlsq_bwd")


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(pass_id: int, mesh: _Mesh, device, **tensors) -> None:
    """One pass on the card: `tensors` name FvData's fields."""
    global LAUNCHES_FV_WLSQ, LAUNCHES_FV_FACE, LAUNCHES_FV_CELL
    global LAUNCHES_FV_LOSS, LAUNCHES_FV_SMOOTH, LAUNCHES_FV_CELL_BWD
    global LAUNCHES_FV_NODE_BWD, LAUNCHES_FV_WLSQ_BWD
    data = _Data(**{k: _ptr(v) for k, v in tensors.items()})
    _ok(_lib().gfvgn_fv_pass(pass_id, ctypes.addressof(mesh),
                             ctypes.addressof(data),
                             torch.cuda.current_stream(device).cuda_stream),
        _PASS_NAMES[pass_id])
    if pass_id == WLSQ:
        LAUNCHES_FV_WLSQ += 1
    elif pass_id == FACE:
        LAUNCHES_FV_FACE += 1
    elif pass_id == CELL:
        LAUNCHES_FV_CELL += 1
        LAUNCHES_FV_LOSS += 1
    elif pass_id == SMOOTH:
        LAUNCHES_FV_SMOOTH += 1
    elif pass_id == CELL_BWD:
        LAUNCHES_FV_CELL_BWD += 1
    elif pass_id == NODE_BWD:
        LAUNCHES_FV_NODE_BWD += 1
    else:
        LAUNCHES_FV_WLSQ_BWD += 1


def _empty(like, *shape):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# ---- the residual, forward and backward ----

def _phi(uvp_new, uv_hat, uv_old):
    return torch.cat([uvp_new, uv_hat, uv_old], dim=-1).reshape(-1, 7)


def forward_passes(lists, sample, uvp_new, uv_hat, uv_old, ncn_smooth):
    """(losses: four [B], rt [B, N, 3] or None, uvp_cell [B, C, 3], saved:
    the records the backward reads)."""
    b, n, e, c, _, _ = lists.sizes
    if uvp_new.device.type == "cuda":
        mesh = _mesh(sample, lists)
        dev = uvp_new.device
        ins = dict(uvp_new=uvp_new, uv_hat=uv_hat, uv_old=uv_old)
        grad = _empty(uvp_new, b, n, 7, 2)
        launch(WLSQ, mesh, dev, grad=grad, **ins)
        rec = _empty(uvp_new, b, e, REC)
        launch(FACE, mesh, dev, grad=grad, face_rec=rec, **ins)
        ucell, sq = _empty(uvp_new, b, c, 3), _empty(uvp_new, b, c, 4)
        roots = _empty(uvp_new, 4, b)
        losses = [_empty(uvp_new, b) for _ in range(4)]
        launch(CELL, mesh, dev, grad=grad, face_rec=rec, uvp_cell=ucell,
               cell_sq=sq, roots=roots, loss0=losses[0], loss1=losses[1],
               loss2=losses[2], loss3=losses[3], **ins)
        rt = den = None
        if ncn_smooth:
            rt, den = _empty(uvp_new, b, n, 3), _empty(uvp_new, b, n)
            launch(SMOOTH, mesh, dev, uvp_cell=ucell, rt=rt, den=den)
        return losses, rt, ucell, (mesh, grad, rec, roots, den)
    g = _geo(sample)
    phi = _phi(uvp_new, uv_hat, uv_old)
    grad = wlsq_reference(lists, g, phi)
    rec = face_reference(g, phi, grad)
    ucell, _, roots, losses = cell_reference(lists, g, phi, grad, rec)
    rt = den = None
    if ncn_smooth:
        rt, den = smooth_reference(lists, g, ucell)
        rt = rt.reshape(b, n, 3)
    return (list(losses), rt, ucell.reshape(b, c, 3),
            (g, grad, rec, roots, den))


def backward_passes(lists, saved, ins, g_loss, g_cell, g_rt):
    """(d uvp_new [B, N, 3], d uv_hat [B, N, 2], d uv_old [B, N, 2])."""
    b, n, e, c, k, _ = lists.sizes
    uvp_new, uv_hat, uv_old = ins
    if uvp_new.device.type == "cuda":
        mesh, grad, rec, roots, den = saved
        dev = uvp_new.device
        cont = lambda t: None if t is None else t.contiguous()
        g_loss = [cont(t) for t in g_loss]
        sbuf, cbuf = _empty(uvp_new, b, k, REC), _empty(uvp_new, b, c,
                                                        CELL_REC)
        launch(CELL_BWD, mesh, dev, uvp_new=uvp_new, uv_hat=uv_hat,
               uv_old=uv_old, grad=grad, face_rec=rec, roots=roots,
               den=den, g_loss0=g_loss[0], g_loss1=g_loss[1],
               g_loss2=g_loss[2], g_loss3=g_loss[3], g_cell=cont(g_cell),
               g_rt=cont(g_rt), slot_buf=sbuf, cell_buf=cbuf)
        dphi, dgrad = _empty(uvp_new, b, n, 7), _empty(uvp_new, b, n, 7, 2)
        launch(NODE_BWD, mesh, dev, slot_buf=sbuf, cell_buf=cbuf, dphi=dphi,
               dgrad=dgrad)
        d_new, d_hat = _empty(uvp_new, b, n, 3), _empty(uvp_new, b, n, 2)
        d_old = _empty(uvp_new, b, n, 2)
        launch(WLSQ_BWD, mesh, dev, dphi=dphi, dgrad=dgrad, d_new=d_new,
               d_hat=d_hat, d_old=d_old)
        return d_new, d_hat, d_old
    g, grad, rec, roots, den = saved
    phi = _phi(uvp_new, uv_hat, uv_old)
    flat = lambda t: None if t is None else t.reshape(-1, 3)
    sbuf, crec = cell_bwd_reference(lists, g, phi, grad, rec, roots, g_loss,
                                    flat(g_cell), flat(g_rt), den)
    dphi, dgrad = node_bwd_reference(lists, g, sbuf, crec)
    d = wlsq_bwd_reference(lists, g, dgrad, dphi).reshape(b, n, 7)
    return d[..., 0:3], d[..., 3:5], d[..., 5:7]


class _ResidualFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uvp_new, uv_hat, uv_old, sample, lists, ncn_smooth):
        ctx.set_materialize_grads(False)
        ins = tuple(t.contiguous() for t in (uvp_new, uv_hat, uv_old))
        losses, rt, ucell, saved = forward_passes(lists, sample, *ins,
                                                  ncn_smooth)
        ctx.save_for_backward(*ins)
        # the saved FvMesh points into the sample's tensors: keep them
        ctx.sample, ctx.lists, ctx.saved = sample, lists, saved
        ctx.ncn = ncn_smooth
        outs = (*losses, ucell) + ((rt,) if ncn_smooth else ())
        return outs

    @staticmethod
    def backward(ctx, *grads):
        g_loss, g_cell = grads[0:4], grads[4]
        g_rt = grads[5] if ctx.ncn else None
        if all(t is None for t in grads):
            return None, None, None, None, None, None
        d_new, d_hat, d_old = backward_passes(
            ctx.lists, ctx.saved, ctx.saved_tensors, g_loss, g_cell, g_rt)
        return d_new, d_hat, d_old, None, None, None


def residual(uvp_new: torch.Tensor, uv_hat: torch.Tensor,
             uv_old: torch.Tensor, sample, ncn_smooth: bool,
             lists: FvLists):
    """`integrate_residuals(uvp_new, uv_hat, uv_old, sample, "2nd",
    conserved_form=True, ncn_smooth)` through the batch's lists (of
    `build_lists(sample)`), differentiable in the three states: ((cont,
    mom_x, mom_y, press) [B] each, rt_uvp_new [B, N, 3], uvp_cell_new
    [B, C, 3])."""
    if sample.wlsq_S.shape[-1] != K:
        raise ValueError(f"fv_csr takes order '2nd' (k = {K}), got "
                         f"k = {sample.wlsq_S.shape[-1]}")
    for t in (uvp_new, uv_hat, uv_old):
        if t.dtype != torch.float32:
            raise TypeError(f"fv_csr takes float32 states, got {t.dtype}")
    outs = _ResidualFn.apply(uvp_new, uv_hat, uv_old, sample, lists,
                             ncn_smooth)
    rt = outs[5] if ncn_smooth else uvp_new
    return tuple(outs[0:4]), rt, outs[4]
