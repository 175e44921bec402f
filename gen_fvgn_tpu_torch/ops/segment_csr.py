"""The segment engine's GraphNet transfers between nodes and faces, each one
pass over per-sample incidence lists, on the kernels of csrc/segment_csr.cu.

Replaces no TPU kernel. The JAX package's GraphNet blocks
(`gen_fvgn_tpu/models/gn.py`) move rows between nodes and faces with
`jax.ops.segment_sum` and row `take`s, which XLA lowers to its scatter and
gather. The port's plain version (`ops/segment.py`, which the model keeps
for CPU tensors) gathers node rows into [B, E, h] face tensors, masks them
and `index_add`s them back onto nodes; on the card that is a bf16 atomic
add, and each intermediate is written and read again only to be summed.

* `build_incidence`, once a batch (`ops.mesh_lists`, the engine's one
  place that builds it): for each sample and node, the unmasked
  faces where the node is receiver and those where it is sender, each list
  in ascending face order, each entry with the face's row and the
  neighbour's node row (rows flattened over the batch: node b·N + n, face
  b·E + f). A stable sort on the device, integer-exact; the degree is the
  two lists' lengths.
* (a) `nbr_sum`, N←N: out[n] = Σ_{f: r(f)=n} x[s(f)] + Σ_{f: s(f)=n} x[r(f)]
  (kernel `seg_nbr_sum`). The operator is symmetric: its backward is itself.
* (b) `inc_sum`, N←E: out[n] = Σ_{f: r(f)=n} e[f, cr:cr+w]
  + Σ_{f: s(f)=n} e[f, cs:cs+w] (kernel `seg_inc_sum`); backward (c).
* (c) `gather_faces`, E←N: out[f, cr:cr+w] = y[r(f)], out[f, cs:cs+w] =
  y[s(f)], masked faces zero (kernel `seg_collect`); backward (b). `collect`
  is the EdgeBlock's [agg@s, agg@r, edge_attr] by the same kernel, written
  once into the 3h-wide input of the edge MLP; its backward is (b) on the
  first two windows of the cotangent.

Masked faces: the sums skip them, as the plain masked sums add zeros for
them. `collect` gathers every face's rows, as `gather_rows` does (a masked
face's rows are garbage that no masked reduction reads), and its backward
sums the unmasked faces only: the plain version would add a masked face's
cotangent onto its node ids, and the nets give those rows none (their edge
MLP rows receive a zero cotangent, since every reduction over faces masks).

Rounding, the plain version's: a list sums in the data's type in
ascending face order, rounding after every add, and the two lists' results
are added and rounded once. That is what the CPU `index_add` of
`ops/segment.py` computes with the engine's int32 ids (with int64 ids the
CPU `index_add` of torch 2.13 accumulates bf16 in float32 instead), and
what JAX's `segment_sum` computes; so the kernels equal the CPU plain
version's bits in both types (with ±0 counted equal), and two runs give
the same bits.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version through the lists (`list_sum_reference`, `gather_reference`). What
bounds the kernels: bytes (a row is a short gather-accumulate); their times
are in PERF.md.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

# incremented once per kernel launch, and nowhere else
LAUNCHES_NBR_SUM = 0
LAUNCHES_INC_SUM = 0
LAUNCHES_COLLECT = 0


class Incidence(NamedTuple):
    """A batch's incidence lists, flattened over the batch (node row
    b·N + n, face row b·E + f). The entries past a list's last row pointer
    are masked faces', never read."""
    recv_ptr: torch.Tensor    # [B·N + 1] int32: row pointers
    recv_face: torch.Tensor   # [B·E] int32: face rows where the node receives
    recv_nbr: torch.Tensor    # [B·E] int32: those faces' sender node rows
    send_ptr: torch.Tensor    # [B·N + 1] int32
    send_face: torch.Tensor   # [B·E] int32: face rows where the node sends
    send_nbr: torch.Tensor    # [B·E] int32: those faces' receiver node rows
    face_s: torch.Tensor      # [B·E] int32: each face's sender node row
    face_r: torch.Tensor      # [B·E] int32: each face's receiver node row
    face_mask: torch.Tensor   # [B·E] bool
    deg: torch.Tensor         # [B, N, 1] float32: the two lists' lengths

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(B, N, E)."""
        b, n, _ = self.deg.shape
        return b, n, self.face_s.shape[0] // b


def build_incidence(face_node: torch.Tensor, face_mask: torch.Tensor,
                    n_nodes: int) -> Incidence:
    """The incidence lists of face_node [B, 2, E] (sender, receiver ids into
    each sample's own n_nodes rows) under face_mask [B, E], on their
    device, with no host synchronisation: a stable sort of the faces by
    node row, masked faces sorted past every row."""
    b, _, e = face_node.shape
    rows = b * n_nodes
    if rows >= 2 ** 31 - 1 or b * e >= 2 ** 31:
        raise ValueError(f"{b} x {n_nodes} nodes or {b} x {e} faces exceed "
                         f"the lists' 32-bit rows")
    dev, i32 = face_node.device, torch.int32
    off = torch.arange(b, device=dev, dtype=i32)[:, None] * n_nodes
    s = (face_node[:, 0].to(i32) + off).reshape(-1)
    r = (face_node[:, 1].to(i32) + off).reshape(-1)
    mask = face_mask.reshape(-1).to(torch.bool)
    ends = torch.arange(rows + 1, device=dev, dtype=i32)

    def lists(key, other):
        keys, faces = torch.sort(torch.where(mask, key, rows), stable=True)
        ptr = torch.searchsorted(keys, ends, out_int32=True)
        return ptr, faces.to(i32), other[faces]

    recv, send = lists(r, s), lists(s, r)
    deg = (torch.diff(recv[0]) + torch.diff(send[0])).to(torch.float32)
    return Incidence(*recv, *send, s, r, mask.contiguous(),
                     deg.reshape(b, n_nodes, 1))


# ---- the plain versions through the lists (CPU tensors, and the
# kernels' yardstick on the card) ----

def _list_rows(ptr, idx, src_rows, col, width):
    """Each list's source rows summed in their type in the list's order."""
    lens = torch.diff(ptr).to(torch.int64)
    start = ptr[:-1].to(torch.int64)
    out = torch.zeros((lens.shape[0], width), dtype=src_rows.dtype,
                      device=src_rows.device)
    window = src_rows[:, col:col + width]
    for k in range(int(lens.max()) if lens.numel() else 0):
        live = torch.nonzero(lens > k).reshape(-1)
        out[live] += window[idx[start[live] + k].to(torch.int64)]
    return out


def list_sum_reference(inc: Incidence, src: torch.Tensor, faces: bool,
                       col_r: int, col_s: int, width: int) -> torch.Tensor:
    """`seg_nbr_sum` (faces False: src [B, N, W] node rows) or `seg_inc_sum`
    (faces True: src [B, E, W] face rows) in plain PyTorch, the kernel's
    rounding points: [B, N, width] in src's type."""
    b, n, _ = inc.shape
    rows = src.reshape(-1, src.shape[-1])
    sums = [_list_rows(ptr, face if faces else nbr, rows, col, width)
            for ptr, face, nbr, col in (
                (inc.recv_ptr, inc.recv_face, inc.recv_nbr, col_r),
                (inc.send_ptr, inc.send_face, inc.send_nbr, col_s))]
    return (sums[0] + sums[1]).reshape(b, n, width)


def gather_reference(inc: Incidence, windows: Sequence, width: int,
                     out_width: int, masked: bool) -> torch.Tensor:
    """`seg_collect` in plain PyTorch: windows (src, which, col) with which
    "s" / "r" (src [B, N, width] rows of each face's sender / receiver) or
    None (src [B, E, width], the face's own row); [B, E, out_width], zero
    outside the windows and, when `masked`, on masked faces."""
    b, _, e = inc.shape
    src0 = windows[0][0]
    out = torch.zeros((b * e, out_width), dtype=src0.dtype,
                      device=src0.device)
    for src, which, col in windows:
        rows = src.reshape(-1, src.shape[-1])
        ids = {"s": inc.face_s, "r": inc.face_r}.get(which)
        out[:, col:col + width] = rows if ids is None else rows[ids.long()]
    if masked:
        out[~inc.face_mask] = 0
    return out.reshape(b, e, out_width)


# ---- the launches ----

def _check(t: torch.Tensor, inc: Incidence, rows: int, name: str):
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bfloat16 or float32, got {t.dtype}")
    if t.ndim != 3 or t.shape[0] != inc.shape[0] or t.shape[1] != rows:
        raise ValueError(f"{name}: expected [{inc.shape[0]}, {rows}, F], got "
                         f"{tuple(t.shape)}")
    if inc.recv_ptr.device != t.device:
        raise ValueError(f"{name}: the lists and the data are on different "
                         f"devices")


def _vec(t: torch.Tensor, width: int, cols: Sequence[int]) -> int:
    """1 where every row, window and pointer is 16-byte aligned."""
    step = 16 // t.element_size()
    return int(width % step == 0 and t.shape[-1] % step == 0
               and t.data_ptr() % 16 == 0 and all(c % step == 0 for c in cols))


def _list_sum(inc: Incidence, src: torch.Tensor, faces: bool, col_r: int,
              col_s: int, width: int) -> torch.Tensor:
    b, n, e = inc.shape
    name = "seg_inc_sum" if faces else "seg_nbr_sum"
    _check(src, inc, e if faces else n, name)
    if max(col_r, col_s) + width > src.shape[-1] or min(col_r, col_s) < 0:
        raise ValueError(f"{name}: windows at {col_r}, {col_s} of {width} "
                         f"columns overrun {src.shape[-1]}")
    if src.device.type != "cuda":
        return list_sum_reference(inc, src, faces, col_r, col_s, width)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    global LAUNCHES_NBR_SUM, LAUNCHES_INC_SUM
    src = src.contiguous()
    out = torch.empty((b, n, width), dtype=src.dtype, device=src.device)
    idx_r, idx_s = ((inc.recv_face, inc.send_face) if faces
                    else (inc.recv_nbr, inc.send_nbr))
    err = load_library().gfvgn_seg_list_sum(
        int(faces), inc.recv_ptr.data_ptr(), idx_r.data_ptr(),
        inc.send_ptr.data_ptr(), idx_s.data_ptr(), src.data_ptr(),
        src.shape[-1], col_r, col_s, out.data_ptr(), width, b * n, width,
        int(src.dtype == torch.bfloat16), _vec(src, width, (col_r, col_s)),
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if faces:
        LAUNCHES_INC_SUM += 1
    else:
        LAUNCHES_NBR_SUM += 1
    return out


def _gather(inc: Incidence, windows: Sequence, width: int, out_width: int,
            masked: bool) -> torch.Tensor:
    b, n, e = inc.shape
    if not 1 <= len(windows) <= 3:
        raise ValueError("seg_collect takes one to three windows")
    for src, which, col in windows:
        _check(src, inc, e if which is None else n, "seg_collect")
        if src.shape[-1] != width or col < 0 or col + width > out_width:
            raise ValueError(f"seg_collect: a window of {src.shape[-1]} "
                             f"columns at {col} of {out_width}, expected "
                             f"{width}")
    dt = windows[0][0].dtype
    if any(src.dtype != dt for src, _, _ in windows):
        raise TypeError("seg_collect: windows of different types")
    if windows[0][0].device.type != "cuda":
        return gather_reference(inc, windows, width, out_width, masked)
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    global LAUNCHES_COLLECT
    srcs = [(src.contiguous(), which, col) for src, which, col in windows]
    covered = sorted(col for _, _, col in windows)
    tiles = covered == list(range(0, out_width, width))
    out = (torch.empty if tiles else torch.zeros)(
        (b, e, out_width), dtype=dt, device=windows[0][0].device)
    args = []
    for k in range(3):
        if k < len(srcs):
            src, which, col = srcs[k]
            ids = {"s": inc.face_s, "r": inc.face_r}.get(which)
            args += [None if ids is None else ids.data_ptr(), src.data_ptr(),
                     width, col]
        else:
            args += [None, None, 0, 0]
    vec = all(_vec(src, width, (col,)) for src, _, col in srcs) and _vec(
        out, width, covered)
    err = load_library().gfvgn_seg_collect(
        len(windows), *args,
        inc.face_mask.data_ptr() if masked else None, out.data_ptr(),
        out_width, b * e, width, int(dt == torch.bfloat16), int(vec),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_collect launch failed: CUDA error {err}")
    LAUNCHES_COLLECT += 1
    return out


# ---- the differentiable forms ----

class _NbrSumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inc):
        ctx.inc = inc
        return _list_sum(inc, x, False, 0, 0, x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return _NbrSumFn.apply(g, ctx.inc), None


class _IncSumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, inc, col_r, col_s, width):
        ctx.inc, ctx.cols, ctx.e_width = inc, (col_r, col_s), e.shape[-1]
        return _list_sum(inc, e, True, col_r, col_s, width)

    @staticmethod
    def backward(ctx, g):
        col_r, col_s = ctx.cols
        return (_GatherFacesFn.apply(g, ctx.inc, col_r, col_s, ctx.e_width),
                None, None, None, None)


class _GatherFacesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, inc, col_r, col_s, out_width):
        ctx.inc, ctx.cols, ctx.width = inc, (col_r, col_s), y.shape[-1]
        return _gather(inc, ((y, "r", col_r), (y, "s", col_s)), y.shape[-1],
                       out_width, masked=True)

    @staticmethod
    def backward(ctx, g):
        col_r, col_s = ctx.cols
        return (_IncSumFn.apply(g, ctx.inc, col_r, col_s, ctx.width),
                None, None, None, None)


class _CollectFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, agg, edge_attr, inc):
        ctx.inc, h = inc, agg.shape[-1]
        return _gather(inc, ((agg, "s", 0), (agg, "r", h),
                             (edge_attr, None, 2 * h)), h, 3 * h,
                       masked=False)

    @staticmethod
    def backward(ctx, g):
        h = g.shape[-1] // 3
        return (_IncSumFn.apply(g, ctx.inc, h, 0, h), g[..., 2 * h:], None)


def nbr_sum(x: torch.Tensor, inc: Incidence) -> torch.Tensor:
    """(a): x [B, N, F] → [B, N, F], each node's neighbours summed over its
    receiver list (their senders' rows) and its sender list (their
    receivers' rows); differentiable."""
    return _NbrSumFn.apply(x, inc)


def _apart(col_r: int, col_s: int, width: int):
    if abs(col_r - col_s) < width:
        raise ValueError(f"the windows at {col_r} and {col_s} of {width} "
                         f"columns overlap")


def inc_sum(e: torch.Tensor, inc: Incidence, col_r: int, col_s: int,
            width: int) -> torch.Tensor:
    """(b): e [B, E, W] → [B, N, width]: each node's receiver list sums
    columns col_r:col_r+width of its faces' rows, its sender list columns
    col_s:col_s+width (two windows apart); differentiable."""
    _apart(col_r, col_s, width)
    return _IncSumFn.apply(e, inc, col_r, col_s, width)


def gather_faces(y: torch.Tensor, inc: Incidence, col_r: int, col_s: int,
                 out_width: int) -> torch.Tensor:
    """(c): y [B, N, w] → [B, E, out_width]: columns col_r:col_r+w of a
    face's row are its receiver's row of y, col_s:col_s+w its sender's,
    zero elsewhere and on masked faces; differentiable (the transpose of
    `inc_sum`)."""
    _apart(col_r, col_s, y.shape[-1])
    return _GatherFacesFn.apply(y, inc, col_r, col_s, out_width)


def collect(agg: torch.Tensor, edge_attr: torch.Tensor,
            inc: Incidence) -> torch.Tensor:
    """The EdgeBlock's MLP input [agg@s, agg@r, edge_attr]: agg [B, N, h],
    edge_attr [B, E, h] → [B, E, 3h], written once; differentiable (its
    backward sums the unmasked faces' cotangents, see the module's
    docstring)."""
    if edge_attr.shape[-1] != agg.shape[-1]:
        raise ValueError(f"collect: agg has {agg.shape[-1]} columns, "
                         f"edge_attr {edge_attr.shape[-1]}")
    return _CollectFn.apply(agg, edge_attr, inc)
