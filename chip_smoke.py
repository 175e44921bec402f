#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `gen_fvgn_tpu_torch/csrc/` with nvcc,
holds each kernel, forward and backward, against its plain PyTorch version
on the card at the shapes of the main path (K1 in each form a train step
launches, `SPMM_FORMS`, the node aggregation's 64-column windows among
them; K2-K7 at hidden width 128 and again at 256; the Transolver kernels
K5-K7 also at the shapes the JAX package fuses beyond the nets', C 768
and 1024, (C, H, G) = (128, 16, 8), (512, 4, 128), (384, 6, 64), at batch
2; the paired sparse applies K8 and K9 at the paired path's), then drives
six paths on the
101x101-node synthetic cavity at batch 8, with weights from
torch.Generator().manual_seed(0), all with the Config's defaults
(TransFVGN_v2: hidden 128, 2 processors of 3 message-passing blocks and a
Transolver block each, 8 heads, 32 slices, bf16 stream) unless named:

  * the main path, training: 5 steps of `make_train_step_block` from
    `init_train_state_block`, batches from `EnvPool.block_batches` and
    `gather_block`, `payback_block` after the last; per step 48 spmm
    (18 forward, 30 on the transposes in the backward; 24 of them the
    composed node aggregation's 64-column windows), 14 + 14
    fused_mlp_ln forward and backward, 1 + 1 fused_mlp_noln, 2 + 2
    fused_premlp_res and 2 + 2 fused_slice_pool launches. Step 1's
    gradients with the kernels are held against those with the kernels'
    plain versions on the card;
  * the rollout of the same net, 5 steps through `rollout_block`; per step
    18 spmm, 14 fused_mlp_ln, 1 fused_mlp_noln, 2 fused_premlp_res and 2
    fused_slice_pool launches;
  * the rollout of the FVGN net (3 message-passing blocks, no attention),
    3 steps; per step 9 spmm, 8 fused_mlp_ln, 1 fused_mlp_noln;
  * the paired path: TransFVGN_v2 with the same weights and both paired
    sparse applies on (`gather_pair=True, node_pair=True`), 3 rollout steps
    (per step 6 spmm, 12 pair_sum and the forward MLP/attention counts
    above) and 3 train steps (24 spmm, 12 pair_sum, 6 pair_transpose and
    the MLP/attention counts of the main path), each step 1 held against
    the plain versions on the card and logged against the unpaired net's
    step 1. The main path launches neither pair kernel, so their launches
    in the kernels line are the paired train steps';
  * FVGN at hidden width 256 (the MLP kernels at H = 256; the node MLP's
    parts 128 + 256 wide) at batch 2 on the same statics: one rollout step
    (9 spmm, 8 fused_mlp_ln, 1 fused_mlp_noln) and one train step (24
    spmm, 8 + 8 fused_mlp_ln, 1 + 1 fused_mlp_noln), the rollout step and
    step 1's gradients held against the plain versions on the card;
  * TransFVGN_v2 at hidden width 256 the same way (the Transolver kernels
    at C = 256: K5f/K5b with the hidden width 512, K6/K7 with 8 heads of 32
    and 32 slices; the MLP kernels at H = 256): one rollout step with the
    main path's rollout launches and one train step with its train-step
    launches.

Each path's launch counters are set to 0 just before it and read just
after; the script checks them, finite outputs, zero padded nodes, a state
or parameters that move, and step 1 of each rollout against the same step
run with the kernels' plain versions on the card. The kernels line lists
K1's forms ("forms", each with its launches a train and a rollout step,
and their sum "train_step_ms"; the entry's own times are nbr_r at full
width, the form the node aggregation took before it used windows), the
K2-K7 times at hidden 256 (the same row counts) under "hidden_256", K5-K7
at the shapes above under "repaired_shapes", and for K5b and K7 the bytes
their two passes move ("design_bytes") beside the bound of the function
itself.

Needs one CUDA card and nvcc; exits non-zero without them, and on any phase
that fails. float32 products run in full float32: TF32 is switched off
here for matmuls and cuDNN.

Timing: CUDA events around single launches after a warm-up, median of 20,
with a 256 MB buffer rewritten between launches so that each launch finds
the 50 MB L2 cold (the rewrite, ahead of the first event, also keeps the
card busy while the host enqueues the launch, so the wrapper's host time
stays out). A train step is timed on the host clock, ending in a
synchronize.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
BF16_TENSOR_FLOPS = 989e12      # dense bf16 tensor-core peak
F32_FLOPS = 67e12               # float32 outside the tensor cores

BATCH, STEPS, FVGN_STEPS, TRAIN_STEPS, MESH_N = 8, 5, 3, 5, 100
PAIR_STEPS = 3                  # rollout and train steps of the paired path
BF16_EPS = 2.0 ** -8            # one bf16 rounding, relative


def log(msg):
    print(msg, flush=True)


def median_ms(fn, flush_buf, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush_buf.add_(1.0)                     # evict L2
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def ulps_of_scale(ref, n):
    """n bf16 ulps at the magnitude of max|ref|."""
    scale = float(ref.abs().max())
    return n * 2.0 ** (np.floor(np.log2(scale)) - 7)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def err_stats(got, ref):
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rel = diff / ref.abs().clamp_min(1e-6)
    return float(diff.max()), float(rel[ref.abs() > 1e-3].max())


def bound(moved, tensor_flops, f32_flops=0.0):
    """(bound_ms, bound_by): bytes over the memory rate against operations
    over the peak of their type (bf16 tensor cores, float32 CUDA cores;
    the two units run side by side, so the larger of the two counts)."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(tensor_flops / BF16_TENSOR_FLOPS, f32_flops / F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# K1's forms in a TransFVGN_v2 train step (6 GnBlocks), as (name, operator,
# operand columns, window start, output width, launches per train step,
# launches per rollout step): the neighbour sum adj and its transpose, the
# gathers' transposes (the EdgeBlock's backward), the composed node
# aggregation's two 64-column windows (forward: N <- E, out [.., 64];
# backward: E <- N into a half of one [.., E, 128] gradient), and, for
# comparison with the parent, the full-width nbr_r/nbr_s applies and their
# transposes it launched instead (none now)
SPMM_FORMS = (
    ("adj", "adj.fwd", 128, 0, 128, 6, 6),
    ("adj^T", "adj.bwd", 128, 0, 128, 6, 0),
    ("gather_s^T", "gather_s.bwd", 128, 0, 128, 6, 0),
    ("gather_r^T", "gather_r.bwd", 128, 0, 128, 6, 0),
    ("nbr_r[:64]", "nbr_r.fwd", 128, 0, 64, 6, 6),
    ("nbr_s[64:]", "nbr_s.fwd", 128, 64, 64, 6, 6),
    ("nbr_r^T->[:64]", "nbr_r.bwd", 64, 0, 128, 6, 0),
    ("nbr_s^T->[64:]", "nbr_s.bwd", 64, 64, 128, 6, 0),
    ("nbr_r", "nbr_r.fwd", 128, 0, 128, 0, 0),
    ("nbr_s", "nbr_s.fwd", 128, 0, 128, 0, 0),
    ("nbr_r^T", "nbr_r.bwd", 128, 0, 128, 0, 0),
    ("nbr_s^T", "nbr_s.bwd", 128, 0, 128, 0, 0),
)


def spmm_form(static, form, gen, batch=BATCH):
    """(operator, operand window, output window, its full output) of one of
    SPMM_FORMS, operands bf16 from `gen`: a window form reads columns
    c0 .. c0 + 64 of a 128-wide operand, or writes a 64-wide result into
    columns c0 .. of a 128-wide output."""
    _, path, width, c0, out_w, _, _ = form
    name, direction = path.split(".")
    op = getattr(getattr(static.ops, name), direction)
    x = torch.randn(batch, op.n_in, width, generator=gen,
                    device="cuda").to(torch.bfloat16)
    f = min(width, out_w)
    xw = x[..., c0:c0 + f] if width > f else x
    full = torch.zeros(batch, op.n_out, out_w, device="cuda",
                       dtype=torch.bfloat16)
    ow = full[..., c0:c0 + f] if out_w > f else full
    return op, xw, ow, full


def check_spmm(static, flush_buf, gen):
    """K1 in every form a train step launches (SPMM_FORMS) at [8, n, 128]
    bf16: each against its plain version on the same window (one bf16
    rounding, padded rows zero, the same bits twice), timed beside its
    bound and the library call (torch.sparse.mm on the same operator, the
    batch folded into the columns outside the timing)."""
    from gen_fvgn_tpu_torch.ops.spmm import spmm, spmm_reference
    rows = []
    for form in SPMM_FORMS:
        name, _, width, c0, out_w, per_train, per_roll = form
        op, xw, ow, full = spmm_form(static, form, gen)
        f = xw.shape[-1]
        spmm(op, xw, out=ow)
        again = spmm(op, xw)
        ref = spmm_reference(op, xw)
        torch.cuda.synchronize()
        if not torch.equal(ow, again):
            raise RuntimeError(f"spmm[{name}]: two runs gave different bits")
        if out_w > f and bool((torch.cat([full[..., :c0],
                                          full[..., c0 + f:]], -1) != 0)
                              .any()):
            raise RuntimeError(f"spmm[{name}] wrote outside its window")
        max_abs, max_rel = err_stats(ow, ref)
        # integer weights, float32 accumulation in another order: at most
        # one bf16 rounding of the output
        tol_rel = BF16_EPS
        bad = ((ow.float() - ref.float()).abs()
               > tol_rel * ref.float().abs() + 1e-6)
        if bool(bad.any()) or ow.dtype != torch.bfloat16:
            raise RuntimeError(f"spmm[{name}] disagrees with spmm_reference: "
                               f"max abs {max_abs}, max rel {max_rel}")
        n_real = int((op.crow[1:] > op.crow[:-1]).nonzero().max()) + 1
        if bool((ow[:, n_real:] != 0).any()):
            raise RuntimeError(f"spmm[{name}]: padded rows are not zero")
        a16 = torch.sparse_csr_tensor(op.crow, op.col,
                                      op.val.to(torch.bfloat16),
                                      size=(op.n_out, op.n_in))
        xf = xw.permute(1, 0, 2).reshape(op.n_in, BATCH * f).contiguous()
        lib = torch.sparse.mm(a16, xf).reshape(op.n_out, BATCH, f)
        lib_abs, _ = err_stats(lib.permute(1, 0, 2), ref)
        ms = median_ms(lambda: spmm(op, xw, out=ow), flush_buf)
        plain_ms = median_ms(lambda: spmm_reference(op, xw), flush_buf)
        library_ms = median_ms(lambda: torch.sparse.mm(a16, xf), flush_buf)
        used_rows = int(torch.unique(op.col).numel())
        moved = (BATCH * used_rows * f * 2 + nbytes(ow)
                 + nbytes(op.crow, op.col, op.val))
        # float32 accumulation of the products: CUDA cores
        bound_ms, bound_by = bound(moved, 0.0,
                                   f32_flops=2.0 * op.nnz * BATCH * f)
        rows.append(dict(op=name, nnz=op.nnz, n_out=op.n_out, n_in=op.n_in,
                         f=f, max_abs_err=max_abs, max_rel_err=max_rel,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         launches_per_train_step=per_train,
                         launches_per_rollout_step=per_roll))
        log(f"kernel spmm[{name}] [{BATCH},{op.n_in},{width}]"
            f"{f'[..,{c0}:{c0 + f}]' if width > f else ''}->[{BATCH},"
            f"{op.n_out},{out_w}]{f'[..,{c0}:{c0 + f}]' if out_w > f else ''}"
            f" bf16 nnz={op.nnz}: max_abs_err={max_abs:.3g} "
            f"max_rel_err={max_rel:.3g} (tolerance {tol_rel:.3g} relative; "
            f"library vs plain max_abs {lib_abs:.3g}); two runs bitwise "
            f"equal; ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}); launches a train step {per_train}, a rollout "
            f"step {per_roll}")
    step = sum(r["ms"] * r["launches_per_train_step"] for r in rows)
    step_bound = sum(r["bound_ms"] * r["launches_per_train_step"]
                     for r in rows)
    log(f"  spmm in a train step: {step:.4f} ms in "
        f"{sum(r['launches_per_train_step'] for r in rows)} launches "
        f"(bound {step_bound:.4f} ms)")
    return rows


def _csr_cat(parts, n_out, n_in):
    """One CSR [n_out, n_in] with bf16 values from (op, row offset, column
    offset) pieces: the operators stacked side by side or one above the
    other, for the library call."""
    rows, cols, vals = [], [], []
    for op, r0, c0 in parts:
        counts = op.crow[1:] - op.crow[:-1]
        rows.append(torch.repeat_interleave(
            torch.arange(op.n_out, device=op.crow.device), counts) + r0)
        cols.append(op.col.long() + c0)
        vals.append(op.val)
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals).to(torch.bfloat16),
                                  size=(n_out, n_in)).coalesce()
    return coo.to_sparse_csr()


def check_pairs(static, flush_buf, gen):
    """K8 as the gather pair (y [8, N, 256] on gather_s / gather_r) and as
    the node pair (edge_attr [8, E, 128] on nbr_r / nbr_s), K9 on
    nbr_r.bwd / nbr_s.bwd (g [8, N, 64]), all bf16, each against its plain
    version. Tolerance: one bf16 ulp of the output plus 2^-20 of the sum
    of the magnitudes (float32 sums in another order: where the exact sum
    lies next to a bf16 rounding midpoint, one order lands on it and rounds
    to even, the other does not; the node pair's operands have both signs,
    so a sum may cancel)."""
    import dataclasses

    from gen_fvgn_tpu_torch.ops import pair_spmm as ps
    ops = static.ops
    bf = torch.bfloat16
    variants = [
        ("pair_sum[gather_pair]", ps.pair_sum, ps.pair_sum_reference,
         ops.gather_s.fwd, ops.gather_r.fwd, 256),
        ("pair_sum[node_pair]", ps.pair_sum, ps.pair_sum_reference,
         ops.nbr_r.fwd, ops.nbr_s.fwd, 128),
        ("pair_transpose[node_pair]", ps.pair_transpose,
         ps.pair_transpose_reference, ops.nbr_r.bwd, ops.nbr_s.bwd, 64)]
    rows = {}
    for name, fn, ref_fn, a, b, width in variants:
        x = torch.randn(BATCH, a.n_in, width, generator=gen,
                        device="cuda").to(bf)
        out, again, ref = fn(a, b, x), fn(a, b, x), ref_fn(a, b, x)
        absolute = lambda op: dataclasses.replace(
            op, val=op.val.abs(), dtype=torch.float32, _csr=None)
        mag = ref_fn(absolute(a), absolute(b), x.abs().float())
        torch.cuda.synchronize()
        transpose = fn is ps.pair_transpose
        h = width if transpose else width // 2
        shape = (BATCH, a.n_out, 2 * h if transpose else h)
        diff = (out.float() - ref.float()).abs()
        tol = 2.0 * BF16_EPS * ref.float().abs() + 2.0 ** -20 * mag
        if tuple(out.shape) != shape or out.dtype != bf \
                or not torch.equal(out, again) or bool((diff > tol).any()):
            raise RuntimeError(f"{name} disagrees with its plain version: "
                               f"max abs {float(diff.max())}, shape "
                               f"{tuple(out.shape)} {out.dtype}")
        n_real = int(((a.crow[1:] > a.crow[:-1])
                      | (b.crow[1:] > b.crow[:-1])).nonzero().max()) + 1
        if bool((out[:, n_real:] != 0).any()):
            raise RuntimeError(f"{name}: padded rows are not zero")
        max_abs, max_rel = err_stats(out, ref)
        # the library call: one torch.sparse CSR product on the operators
        # stacked side by side ([A | B] on [y_lo; y_hi], K8) or one above
        # the other ([A; B] on g, K9), bf16 values, the batch folded into
        # the columns; the stacking and relayouts outside the timing
        if transpose:
            lib_a = _csr_cat([(a, 0, 0), (b, a.n_out, 0)], 2 * a.n_out,
                             a.n_in)
            lib_x = x.permute(1, 0, 2).reshape(a.n_in, BATCH * h)
            lib_ref = torch.sparse.mm(lib_a, lib_x).reshape(
                2, a.n_out, BATCH, h).permute(2, 1, 0, 3).reshape(shape)
        else:
            lib_a = _csr_cat([(a, 0, 0), (b, 0, a.n_in)], a.n_out,
                             2 * a.n_in)
            lib_x = torch.cat([x[..., :h], x[..., h:]], dim=1).permute(
                1, 0, 2).reshape(2 * a.n_in, BATCH * h)
            lib_ref = torch.sparse.mm(lib_a, lib_x).reshape(
                a.n_out, BATCH, h).permute(1, 0, 2)
        lib_x = lib_x.contiguous()
        lib_abs, _ = err_stats(lib_ref, ref)
        ms = median_ms(lambda: fn(a, b, x), flush_buf)
        plain_ms = median_ms(lambda: ref_fn(a, b, x), flush_buf)
        library_ms = median_ms(lambda: torch.sparse.mm(lib_a, lib_x),
                               flush_buf)
        # each operand row an operator reads, once (K8 reads H of the 2H
        # channels of a row per operator; K9 reads a row once for both)
        ua, ub = torch.unique(a.col), torch.unique(b.col)
        if transpose:
            read = BATCH * int(torch.unique(torch.cat([ua, ub])).numel()) \
                * h * 2
        else:
            read = BATCH * (int(ua.numel()) + int(ub.numel())) * h * 2
        moved = read + nbytes(out, a.crow, a.col, a.val, b.crow, b.col,
                              b.val)
        bound_ms, bound_by = bound(moved, 0.0, f32_flops=2.0 * (
            a.nnz + b.nnz) * BATCH * h)
        rows[name] = dict(nnz=a.nnz + b.nnz, max_abs_err=max_abs,
                          max_rel_err=max_rel, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        log(f"kernel {name} [{BATCH},{a.n_in},{width}]->{list(shape)} bf16 "
            f"nnz={a.nnz}+{b.nnz}: max_abs_err={max_abs:.3g} "
            f"max_rel_err={max_rel:.3g} (tolerance one bf16 ulp + "
            f"2^-20 of the magnitudes; library vs plain max_abs "
            f"{lib_abs:.3g}); two runs bitwise equal; ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
    return rows


def mlp_weights(gen, k_total, d_out, h=128):
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return dict(w1=g(k_total, h) / max(k_total, 1) ** 0.5, b1=0.1 * g(h),
                w2=g(h, h) / h ** 0.5, b2=0.1 * g(h),
                w3=g(h, d_out) / h ** 0.5, b3=0.1 * g(d_out),
                gamma=1.0 + 0.1 * g(d_out), beta=0.1 * g(d_out))


def check_fused_ln(n_pad, e_pad, flush_buf, gen, h=128):
    """K2 in the variants of the main path at hidden width h (the node MLP's
    first part is h/2 wide, the edge MLP's W1 3h rows, as in the nets)."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (fused_mlp_ln,
                                                  fused_mlp_ln_reference)
    bf = torch.bfloat16
    rnd = lambda m, k: torch.randn(m, k, generator=gen, device="cuda").to(bf)
    mn, me = BATCH * n_pad, BATCH * e_pad
    variants = [
        # name, M, part widths, has pre, w1 rows, res_idx, res_dual
        ("node_encoder(pres-only)", mn, [], True, 12, None, False),
        ("edge_encoder(pres-only)", me, [], True, 15, None, False),
        ("edge_mlp(part+pre,dual)", me, [h], True, 3 * h, 0, True),
        (f"node_mlp(parts {h // 2}+{h},res)", mn, [h // 2, h], False,
         h // 2 + h, 1, False),
    ]
    rows = []
    for name, m, widths, has_pre, k_total, res_idx, res_dual in variants:
        w = mlp_weights(gen, k_total, h, h)
        parts = [rnd(m, k) for k in widths]
        k1 = sum(widths)
        w1s, off = [], k_total - k1        # the parts own the LAST rows of W1
        for k in widths:
            w1s.append(w["w1"][off:off + k].to(bf).contiguous())
            off += k
        pres = (rnd(m, h),) if has_pre else ()
        args = (parts, w1s, w["b1"], w["w2"].to(bf), w["b2"], w["w3"].to(bf),
                w["b3"], w["gamma"], w["beta"], pres)
        run = lambda: fused_mlp_ln(*args, res_idx=res_idx, res_dual=res_dual)
        run_ref = lambda: fused_mlp_ln_reference(*args, res_idx=res_idx,
                                                 res_dual=res_dual)
        outs, refs = run(), run_ref()
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        max_abs = max_rel = tol = 0.0
        for o, r in zip(outs, refs):
            a, rl = err_stats(o, r)
            t = ulps_of_scale(r, 2)
            if a > t or o.dtype != bf or not bool(torch.isfinite(o).all()):
                raise RuntimeError(
                    f"fused_mlp_ln[{name}] H={h} disagrees with its plain "
                    f"version: max abs {a} > {t}")
            max_abs, max_rel, tol = max(max_abs, a), max(max_rel, rl), max(tol, t)
        ms = median_ms(run, flush_buf)
        plain_ms = median_ms(run_ref, flush_buf, iters=5, warmup=1)
        moved = (nbytes(*parts, *pres, *outs, *w1s, args[3], args[5])
                 + 4 * 5 * h)
        bound_ms, bound_by = bound(moved, 2.0 * m * (k1 * h + 2 * h * h))
        rows.append(dict(variant=name, h=h, m=m, max_abs_err=max_abs,
                         max_rel_err=max_rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"kernel fused_mlp_ln[{name}] H={h} M={m} bf16: "
            f"max_abs_err={max_abs:.3g} max_rel_err={max_rel:.3g} "
            f"(tolerance {tol:.3g} abs = 2 bf16 ulps of the output scale) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
    return rows


def check_fused_noln(n_pad, flush_buf, gen, h=128):
    """K4f at the decoder's shape: [8*N, h] bf16 -> [8*N, 3]."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (fused_mlp_noln,
                                                  fused_mlp_noln_reference)
    bf = torch.bfloat16
    m = BATCH * n_pad
    w = mlp_weights(gen, h, 3, h)
    x = torch.randn(m, h, generator=gen, device="cuda").to(bf)
    args = (x, w["w1"].to(bf), w["b1"], w["w2"].to(bf), w["b2"],
            w["w3"].to(bf).contiguous(), w["b3"])
    out, ref = fused_mlp_noln(*args), fused_mlp_noln_reference(*args)
    torch.cuda.synchronize()
    max_abs, max_rel = err_stats(out, ref)
    tol = ulps_of_scale(ref, 2)
    if max_abs > tol or tuple(out.shape) != (m, 3) or out.dtype != bf:
        raise RuntimeError(f"fused_mlp_noln H={h} disagrees with its plain "
                           f"version: max abs {max_abs} > {tol}")
    ms = median_ms(lambda: fused_mlp_noln(*args), flush_buf)
    plain_ms = median_ms(lambda: fused_mlp_noln_reference(*args), flush_buf,
                         iters=5, warmup=1)
    moved = nbytes(x, out, args[1], args[3], args[5]) + 4 * (h + h + 3)
    bound_ms, bound_by = bound(moved, 2.0 * m * (2 * h * h + h * 3))
    row = dict(h=h, m=m, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel fused_mlp_noln H={h} M={m} bf16 -> [M,3]: "
        f"max_abs_err={max_abs:.3g} max_rel_err={max_rel:.3g} (tolerance "
        f"{tol:.3g} abs = 2 bf16 ulps of the output scale) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def check_premlp(n_pad, flush_buf, gen, c=128, batch=BATCH):
    """K5f at the Transolver block's shape: x [batch*N, c] bf16, hidden
    2c."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (fused_premlp_res,
                                                  fused_premlp_res_reference)
    bf = torch.bfloat16
    m, hd = batch * n_pad, 2 * c
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (2.0 * g(m, c) + 0.5).to(bf)
    args = (x, 1.0 + 0.1 * g(c), 0.1 * g(c),
            (g(c, hd) / c ** 0.5).to(bf), 0.1 * g(hd),
            (g(hd, c) / hd ** 0.5).to(bf), 0.1 * g(c))
    out, ref = fused_premlp_res(*args), fused_premlp_res_reference(*args)
    torch.cuda.synchronize()
    max_abs, max_rel = err_stats(out, ref)
    # float32 sums in another order and last-bit exp/sqrtf differences
    # can move one bf16 rounding of u, h or the output by one step
    tol = ulps_of_scale(ref, 2)
    if max_abs > tol or tuple(out.shape) != (m, c) or out.dtype != bf \
            or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"fused_premlp_res C={c} disagrees with its plain "
                           f"version: max abs {max_abs} > {tol}")
    ms = median_ms(lambda: fused_premlp_res(*args), flush_buf)
    plain_ms = median_ms(lambda: fused_premlp_res_reference(*args),
                         flush_buf, iters=5, warmup=1)
    moved = nbytes(x, out, args[3], args[5]) + 4 * (3 * c + hd)
    bound_ms, bound_by = bound(moved, 2.0 * m * (c * hd + hd * c))
    row = dict(c=c, m=m, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel fused_premlp_res C={c} M={m} bf16 [M,{c}]->[M,{c}] hidden "
        f"{hd}: max_abs_err={max_abs:.3g} max_rel_err={max_rel:.3g} "
        f"(tolerance {tol:.3g} abs = 2 bf16 ulps of the output scale) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by})")
    return row


def check_slice_pool(static, flush_buf, gen, c=128, heads=8, slices=32,
                     batch=BATCH):
    """K6 at the attention's shape: x [batch, N, c] bf16, the static node
    mask, `heads` heads of c / heads, `slices` slices, temperature 0.5."""
    from gen_fvgn_tpu_torch.ops.fused_slice_attn import (
        fused_slice_pool_kernel, fused_slice_pool_reference, slice_logits,
        slice_w_tolerance)
    bf = torch.bfloat16
    n = static.pos.shape[0]
    d, hg = c // heads, heads * slices
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = g(batch, n, c).to(bf)
    mask = static.node_mask.to(torch.float32)
    args = (x, mask, (g(c, c) / c ** 0.5).to(bf), 0.1 * g(c),
            (g(c, c) / c ** 0.5).to(bf), 0.1 * g(c),
            (g(d, slices) / d ** 0.5).to(bf), 0.1 * g(slices),
            torch.full((heads,), 2.0, device="cuda"))
    outs = fused_slice_pool_kernel(*args)
    refs = fused_slice_pool_reference(*args)
    again = fused_slice_pool_kernel(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs, again)):
        raise RuntimeError("fused_slice_pool: two runs gave different bits")
    # slice_w: a flipped bf16 rounding of a logit moves its (node, head)
    # group of weights (slice_w_tolerance), and few weights move by more
    # than 2^-7; tokens/norm: float32 sums in another order, a flipped
    # rounding moves one row's contribution
    l_max = float(slice_logits(x, args[4], args[5], args[6], args[7])
                  .float().abs().max())
    w_diff = (outs[0].float() - refs[0].float()).abs()
    w_far = float((w_diff > 2.0 ** -7).float().mean())
    errs, tols = [], []
    for name, o, r, t in (
            ("slice_w", outs[0], refs[0], slice_w_tolerance(l_max, 2.0)),
            ("tokens", outs[1], refs[1], 1e-3 * float(refs[1].abs().max())),
            ("norm", outs[2], refs[2], 1e-3 * float(refs[2].abs().max()))):
        a, _ = err_stats(o, r)
        if a > t or o.shape != r.shape or not bool(torch.isfinite(o).all()):
            raise RuntimeError(f"fused_slice_pool[{name}] C={c} disagrees "
                               f"with its plain version: max abs {a} > {t}")
        errs.append(a)
        tols.append(t)
    if w_far >= 1e-4:
        raise RuntimeError(f"fused_slice_pool: a share {w_far} of the slice "
                           f"weights is more than 2^-7 off")
    ms = median_ms(lambda: fused_slice_pool_kernel(*args), flush_buf)
    plain_ms = median_ms(lambda: fused_slice_pool_reference(*args),
                         flush_buf, iters=5, warmup=1)
    rows = batch * n
    moved = nbytes(x, mask, *outs, args[2], args[4], args[6]) \
        + 4 * (2 * c + slices + heads)
    # the projections and the logits take bf16 operands (tensor cores); the
    # pooling takes float32 w*mask and fx (CUDA cores): per-head blocks only
    bound_ms, bound_by = bound(
        moved, 2.0 * rows * (2 * c * c + c * slices),
        f32_flops=2.0 * rows * c * slices)
    row = dict(c=c, heads=heads, slices=slices, m=rows, max_abs_err=max(errs),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    log(f"kernel fused_slice_pool x [{batch},{n},{c}] bf16, {heads} heads, "
        f"{slices} slices -> slice_w [{batch},{n},{hg}] bf16, tokens "
        f"[{batch},{heads},{slices},{d}], norm [{batch},{heads},{slices}]: "
        f"max_abs_err slice_w={errs[0]:.3g} tokens={errs[1]:.3g} "
        f"norm={errs[2]:.3g} (tolerance {tols[0]:.3g} for a flipped logit "
        f"rounding at max|logit| {l_max:.3g}, {tols[1]:.3g} and "
        f"{tols[2]:.3g} = 1e-3 of the scale; share of weights more than "
        f"2^-7 off {w_far:.3g}, limit 1e-4); two runs bitwise equal; "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by})")
    return row


def named_outputs(out, fields=None):
    """(name, tensor) pairs of a backward's outputs: a NamedTuple, whose
    fields may be tuples of tensors, or a tuple named by `fields`."""
    for name, v in zip(fields or out._fields, out):
        if isinstance(v, tuple):
            yield from ((f"{name}[{i}]", t) for i, t in enumerate(v))
        else:
            yield name, v


def hold_backward(name, run, run_ref, flush_buf, fields=None):
    """Runs a backward kernel twice (the same bits, no atomics) and its
    plain version once; every output within 2 bf16 ulps of its own scale
    (a float32 sum in another order can move a bf16 rounding of dy,
    dh2pre, dh1pre or a projection by one step, and the weight gradients
    sum many rows in another order before their rounding). Returns
    (outputs, a row of max_abs_err over all outputs, the largest share of
    its tolerance an output's error takes, ms and plain_ms)."""
    got, again, ref = run(), run(), run_ref()
    torch.cuda.synchronize()
    pairs = list(zip(named_outputs(got, fields),
                     named_outputs(again, fields),
                     named_outputs(ref, fields)))
    if not all(torch.equal(a, b) for (_, a), (_, b), _ in pairs):
        raise RuntimeError(f"{name}: two runs gave different bits")
    worst, ratio, notes = 0.0, 0.0, []
    for (key, a), _, (_, r) in pairs:
        if a.shape != r.shape or a.dtype != r.dtype \
                or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{name}[{key}]: {a.dtype} {tuple(a.shape)} "
                               f"not finite or not {r.dtype} "
                               f"{tuple(r.shape)}")
        err = float((a.float() - r.float()).abs().max())
        if float(r.abs().max()) == 0.0:
            tol = 0.0
        else:
            tol = ulps_of_scale(r.float(), 2)
        if err > tol:
            raise RuntimeError(f"{name}[{key}] disagrees with its plain "
                               f"version: max abs {err} > {tol}")
        worst = max(worst, err)
        ratio = max(ratio, err / tol if tol else 0.0)
        notes.append(f"{key} {err:.3g}/{tol:.3g}")
    ms = median_ms(run, flush_buf)
    plain_ms = median_ms(run_ref, flush_buf, iters=5, warmup=1)
    log(f"kernel {name}: max_abs_err/tolerance (2 bf16 ulps of each "
        f"output's scale) {', '.join(notes)}; two runs bitwise equal; "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    return got, dict(max_abs_err=worst, err_over_tolerance=ratio, ms=ms,
                     plain_ms=plain_ms)


def with_bound(row, m, moved, tensor_flops, f32_flops=0.0):
    """The row with its M and its bound (see `bound`)."""
    bound_ms, bound_by = bound(moved, tensor_flops, f32_flops)
    return dict(row, m=m, bound_ms=bound_ms, bound_by=bound_by)


def check_mlp_backward(n_pad, e_pad, flush_buf, gen, h=128):
    """K3 on the edge MLP's form at hidden width h (an h-wide part owning
    the last W1 rows, a pre, the residual on the part with both outputs)
    and K4b at the decoder's shape, each against its plain version and
    twice for the same bits; rows batch-major, 8 lanes."""
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    bf = torch.bfloat16
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = {}
    sq = h * h

    # K3: edge MLP, M = 8 * padded faces
    m = BATCH * e_pad
    w = mlp_weights(gen, 3 * h, h, h)
    part, pre = g(m, h).to(bf), g(m, h).to(bf)
    douts = [g(m, h).to(bf), g(m, h).to(bf)]
    args = ([part], [w["w1"][2 * h:].to(bf).contiguous()], w["b1"],
            w["w2"].to(bf), w["b2"], w["w3"].to(bf), w["b3"], w["gamma"],
            [pre], douts, 0, True, BATCH)
    out, row = hold_backward(
        f"fused_mlp_ln_bwd[edge_mlp(part+pre,dual)] H={h}",
        lambda: fm.fused_mlp_ln_bwd(*args),
        lambda: fm.fused_mlp_ln_bwd_reference(*args), flush_buf)
    moved = nbytes(part, pre, *douts, *out.dxs, *out.dpres, *args[1],
                   args[3], args[5], out.dw1s[0], out.dw2, out.dw3) \
        + 4 * 8 * h
    # remat: 3 products; backward: dW3, dh2, dW2, dh1, dW1, dx
    rows["fused_mlp_ln_bwd"] = with_bound(row, m, moved, 2.0 * m * 9 * sq)

    # K4b: decoder, [8 * padded nodes, h] -> 3
    m = BATCH * n_pad
    w = mlp_weights(gen, h, 3, h)
    x, dout = g(m, h).to(bf), g(m, 3).to(bf)
    args = (x, w["w1"].to(bf), w["b1"], w["w2"].to(bf), w["b2"],
            w["w3"].to(bf).contiguous(), w["b3"], dout, BATCH)
    out, row = hold_backward(
        f"fused_mlp_noln_bwd[decoder] H={h}",
        lambda: fm.fused_mlp_noln_bwd(*args),
        lambda: fm.fused_mlp_noln_bwd_reference(*args), flush_buf,
        ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"))
    moved = nbytes(x, dout, out[0], args[1], args[3], args[5], out[1],
                   out[3], out[5]) + 4 * 2 * (2 * h + 3)
    # remat: x W1, h1 W2 (no LayerNorm, so h2 W3 is not needed); backward:
    # dW3 and dh2 (3 wide), dW2, dh1, dW1, dx
    rows["fused_mlp_noln_bwd"] = with_bound(
        row, m, moved, 2.0 * m * (6 * sq + 2 * 3 * h))
    for name, r in rows.items():
        log(f"  {name} H={h}: M={r['m']} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return rows


def check_backward(n_pad, static, flush_buf, gen, c=128, heads=8,
                   slices=32, batch=BATCH, premlp=True, pool=True):
    """K5b at the Transolver MLP's shape (x [batch*N, c], hidden 2c) and K7
    at the attention's (x [batch, N, c], `heads` heads, `slices` slices),
    each against its plain version; rows batch-major, `batch` lanes.
    Beside each bound (the function's own bytes and operations) the bytes
    the kernel's two passes move: the row pass's reads and writes, its bf16
    rows read again by the weight-gradient pass once per output tile they
    feed. `premlp` / `pool` leave out K5b / K7."""
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    bf = torch.bfloat16
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = {}
    hd, sq = 2 * c, c * c
    m = batch * n_pad
    tiles = lambda k: -(-k // 128)

    if premlp:
        # K5b: the Transolver MLP, [batch * padded nodes, c], hidden 2c
        x = (2.0 * g(m, c) + 0.5).to(bf)
        dout = g(m, c).to(bf)
        args = (x, 1.0 + 0.1 * g(c), 0.1 * g(c),
                (g(c, hd) / c ** 0.5).to(bf), 0.1 * g(hd),
                (g(hd, c) / hd ** 0.5).to(bf), 0.1 * g(c), dout, batch)
        out, row = hold_backward(
            f"fused_premlp_res_bwd C={c}",
            lambda: fm.fused_premlp_res_bwd(*args),
            lambda: fm.fused_premlp_res_bwd_reference(*args), flush_buf,
            ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"))
        moved = nbytes(x, dout, out[0], args[3], args[5], out[3], out[5]) \
            + 4 * 2 * (4 * c + hd)
        # the rows pass 1 writes (u16 [M, c], h16 and dh1pre16 [M, 2c]) and
        # pass 2 reads: dW1 = u16^T dh1pre16, dW2 = h16^T dout
        design = moved + 2 * m * (c + 2 * hd) + 2 * m * (
            c * tiles(hd) + hd * tiles(c) + hd * tiles(c) + c * tiles(hd))
        # remat: u W1 (the branch's output h W2 is not needed); backward:
        # dW2, g W2^T, dW1, dh W1^T; each [M, c] x [c, 2c] or its transpose
        rows["fused_premlp_res_bwd"] = dict(with_bound(
            row, m, moved, 2.0 * m * 5 * c * hd), design_bytes=design,
            design_ms=1e3 * design / HBM_BYTES_PER_S)

    if pool:
        # K7: the slice pooling's backward, x [batch, N, c], the static mask
        n = static.pos.shape[0]
        d, hg = c // heads, heads * slices
        x = g(batch, n, c).to(bf)
        mask = static.node_mask.to(torch.float32)
        cots = (g(batch, n, hg).to(bf), g(batch, heads, slices, d),
                g(batch, heads, slices))
        args = (x, mask, (g(c, c) / c ** 0.5).to(bf), 0.1 * g(c),
                (g(c, c) / c ** 0.5).to(bf), 0.1 * g(c),
                (g(d, slices) / d ** 0.5).to(bf), 0.1 * g(slices),
                torch.full((heads,), 2.0, device="cuda"), *cots)
        out, row = hold_backward(
            f"fused_slice_pool_bwd C={c} H={heads} G={slices}",
            lambda: fsa.fused_slice_pool_bwd_kernel(*args),
            lambda: fsa.fused_slice_pool_bwd_reference(*args), flush_buf)
        r = batch * n
        moved = nbytes(x, mask, *cots, out.dx, args[2], args[4], args[6],
                       out.dwfx, out.dwx, out.dwsl_heads) \
            + 4 * (4 * c + 2 * slices + 2 * heads)
        # pass 1 writes dfx16, dxm16 [r, c]; pass 2 reads them and x per
        # tile
        design = moved + 2 * r * 2 * c + 2 * r * 2 * (c + c) * tiles(c)
        # tensor cores: remat fx, xm, the logits; backward dxm, dWsl, dWfx,
        # dWx and dx (two products); float32: dw_m and dfx against dtokens
        rows["fused_slice_pool_bwd"] = dict(with_bound(
            row, r, moved, 2.0 * r * (6 * sq + 3 * c * slices),
            f32_flops=2.0 * 2 * r * c * slices), design_bytes=design,
            design_ms=1e3 * design / HBM_BYTES_PER_S)
    for name, row in rows.items():
        log(f"  {name} C={c}: M={row['m']} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}); the two passes move "
            f"{row['design_bytes'] / 1e6:.1f} MB, {row['design_ms']:.4f} ms "
            f"at the memory rate")
    return rows


def check_repaired_shapes(n_pad, static, flush_buf, gen):
    """The shapes the Transolver kernels took from this slice on, at batch
    2 on the main path's rows (right, not fast): K5f/K5b at C 768 and 1024
    (hidden 2C; the backward in hidden chunks), K6/K7 at (C, H, G) =
    (128, 16, 8), (512, 4, 128) and (384, 6, 64) (their run-time paths),
    each held against its plain version as the main shapes are. Returns
    {kernel: {shape: row}}."""
    out = {k: {} for k in ("fused_premlp_res", "fused_premlp_res_bwd",
                           "fused_slice_pool", "fused_slice_pool_bwd")}
    for c in (768, 1024):
        out["fused_premlp_res"][f"C{c}"] = check_premlp(
            n_pad, flush_buf, gen, c, batch=2)
        out["fused_premlp_res_bwd"][f"C{c}"] = check_backward(
            n_pad, static, flush_buf, gen, c, batch=2,
            pool=False)["fused_premlp_res_bwd"]
    for c, h, gs in ((128, 16, 8), (512, 4, 128), (384, 6, 64)):
        key = f"C{c}-H{h}-G{gs}"
        out["fused_slice_pool"][key] = check_slice_pool(
            static, flush_buf, gen, c, h, gs, batch=2)
        out["fused_slice_pool_bwd"][key] = check_backward(
            n_pad, static, flush_buf, gen, c, h, gs, batch=2,
            premlp=False)["fused_slice_pool_bwd"]
    return out


def launch_counts():
    from gen_fvgn_tpu_torch.ops import (fused_mlp, fused_slice_attn,
                                        pair_spmm, spmm)
    return dict(spmm=spmm.LAUNCHES,
                pair_sum=pair_spmm.LAUNCHES_PAIR_SUM,
                pair_transpose=pair_spmm.LAUNCHES_PAIR_TRANSPOSE,
                fused_mlp_ln=fused_mlp.LAUNCHES_LN,
                fused_mlp_noln=fused_mlp.LAUNCHES_NOLN,
                fused_premlp_res=fused_mlp.LAUNCHES_PREMLP,
                fused_slice_pool=fused_slice_attn.LAUNCHES,
                fused_mlp_ln_bwd=fused_mlp.LAUNCHES_LN_BWD,
                fused_mlp_noln_bwd=fused_mlp.LAUNCHES_NOLN_BWD,
                fused_premlp_res_bwd=fused_mlp.LAUNCHES_PREMLP_BWD,
                fused_slice_pool_bwd=fused_slice_attn.LAUNCHES_BWD)


def zero_counts():
    from gen_fvgn_tpu_torch.ops import (fused_mlp, fused_slice_attn,
                                        pair_spmm, spmm)
    spmm.LAUNCHES = 0
    pair_spmm.LAUNCHES_PAIR_SUM = pair_spmm.LAUNCHES_PAIR_TRANSPOSE = 0
    fused_mlp.LAUNCHES_LN = fused_mlp.LAUNCHES_NOLN = 0
    fused_mlp.LAUNCHES_PREMLP = 0
    fused_mlp.LAUNCHES_LN_BWD = fused_mlp.LAUNCHES_NOLN_BWD = 0
    fused_mlp.LAUNCHES_PREMLP_BWD = 0
    fused_slice_attn.LAUNCHES = fused_slice_attn.LAUNCHES_BWD = 0


def drive(name, cfg, sim, norm_state, dyn, static, steps, per_step, n_real):
    """`steps` rollout steps of `sim` with the counters set to 0 just before
    and read just after; then step 1 again with the plain versions on the
    card. Returns the counts of the rollout and its records."""
    from gen_fvgn_tpu_torch.solve.rollout_block import (make_eval_step_block,
                                                        rollout_block)
    n_pad = static.pos.shape[0]
    make_eval_step_block(cfg, sim)(norm_state, dyn, static)   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    stamps = [time.perf_counter()]
    hist = rollout_block(
        cfg, sim, norm_state, dyn, static, steps,
        export_fn=lambda t, un, uc, rec: stamps.append(time.perf_counter()))
    counts = launch_counts()
    step_ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:])]
    for rec, ms in zip(hist, step_ms):
        for key in ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press"):
            if rec[key].shape != (BATCH,) or not np.isfinite(rec[key]).all():
                raise RuntimeError(f"{name} step {rec['step']}: {key} not "
                                   f"finite")
        un, uc = rec["uvp_node"], rec["uvp_cell"]
        if un.shape != (BATCH, n_pad, 3) or not np.isfinite(un).all() \
                or not np.isfinite(uc).all():
            raise RuntimeError(f"{name} step {rec['step']}: state not finite "
                               f"or of the wrong shape {un.shape}")
        if np.abs(un[:, n_real:]).max() != 0:
            raise RuntimeError(f"{name} step {rec['step']}: padded nodes not "
                               f"zero")
        log(f"{name} rollout step {rec['step']}: "
            f"loss_cont={rec['loss_cont'].mean():.6g} "
            f"loss_mom_x={rec['loss_mom_x'].mean():.6g} "
            f"loss_mom_y={rec['loss_mom_y'].mean():.6g} "
            f"loss_press={rec['loss_press'].mean():.6g} "
            f"max|uvp|={np.abs(un).max():.4g} ms={ms:.2f}")
    expected = {k: per_step.get(k, 0) * steps for k in counts}
    log(f"{name} rollout: {steps} steps, batch {BATCH}, median "
        f"{float(np.median(step_ms)):.2f} ms/step (host clock, state copied "
        f"to the host each step); launches {counts}")
    if counts != expected:
        raise RuntimeError(f"{name}: launch counts {counts} != expected "
                           f"{expected}")
    if np.abs(hist[-1]["uvp_node"] - hist[0]["uvp_node"]).max() == 0:
        raise RuntimeError(f"{name}: the rollout did not move the state")

    # step 1 again with the kernels' plain versions on the card
    plain = make_eval_step_block(cfg, sim, plain_kernels=True)(
        norm_state, dyn, static)
    if launch_counts() != expected:
        raise RuntimeError(f"{name}: the plain step launched a kernel")
    gap = np.abs(plain.uvp_node_new.cpu().numpy() - hist[0]["uvp_node"])
    loss_gap = float(np.abs(plain.loss_cont.cpu().numpy().reshape(-1)
                            - hist[0]["loss_cont"]).max()
                     / np.abs(hist[0]["loss_cont"]).max())
    # a few bf16 roundings of a backbone output of scale 1 (2^-8 each),
    # smoothed over a cell's nodes
    step_tol = 2e-2
    log(f"{name} step 1 kernels vs plain versions on the card: uvp_node max "
        f"gap {gap.max():.3g}, median "
        f"{float(np.median(gap[:, :n_real])):.3g} (tolerance {step_tol}); "
        f"loss_cont rel gap {loss_gap:.3g}")
    if not gap.max() <= step_tol or not loss_gap <= 5e-2:
        raise RuntimeError(f"{name}: step 1 disagrees with the plain "
                           f"versions")
    return counts, hist


def step1_grads(cfg, sim, norm_state, dyn, static, plain):
    """d loss / d parameter of one training step's loss (forward with
    normalizer accumulation, then `training_loss`), with the kernels or
    with their plain versions."""
    import contextlib

    from gen_fvgn_tpu_torch.ops import plain_versions
    from gen_fvgn_tpu_torch.training.forward import training_loss
    from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
    params = list(sim.parameters())
    with (plain_versions() if plain else contextlib.nullcontext()), \
            torch.enable_grad():
        out = forward_batch_block(sim, norm_state, dyn, static, cfg,
                                  accumulate_normalizer=True)
        loss = training_loss(out, cfg)
        grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), grads


def hold_step1_grads(name, cfg, sim, norm_state, dyn, static):
    """Step 1's gradients with the kernels against those with the plain
    versions on the card, on the same batch; raises outside the limits.
    Returns (loss, gradients) with the kernels."""
    loss_k, g_k = step1_grads(cfg, sim, norm_state, dyn, static, False)
    counts = launch_counts()
    loss_p, g_p = step1_grads(cfg, sim, norm_state, dyn, static, True)
    if launch_counts() != counts:
        raise RuntimeError(f"{name}: the plain versions' pass launched a "
                           f"kernel")
    diff = torch.sqrt(sum(((a.float() - b.float()) ** 2).sum()
                          for a, b in zip(g_k, g_p)))
    ref = torch.sqrt(sum((b.float() ** 2).sum() for b in g_p))
    rel = float(diff / ref)
    cos, rels, names = [], [], []
    for n, a, b in zip((n for n, _ in sim.named_parameters()), g_k, g_p):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        if bool(b.any()):
            cos.append(float(a @ b / (a.norm() * b.norm())))
            rels.append(float((a - b).norm() / b.norm()))
            names.append(n)
    worst_cos, worst_rel = int(np.argmin(cos)), int(np.argmax(rels))
    # set from this check's readings on an H100: relative norm of the
    # whole 5.6e-3 (limit 2e-2), largest per tensor 9.6e-3 (3e-2), lowest
    # cosine 1 - 5e-5 (1 - 1e-3), loss 1e-6 relative (1e-4). The per-tensor
    # norm also sees a tensor off by a scale factor, which the cosine
    # cannot.
    rel_tol, tensor_tol, cos_tol = 2e-2, 3e-2, 1 - 1e-3
    log(f"{name} step 1 gradients, kernels vs plain versions on the card: "
        f"loss {loss_k:.7g} vs {loss_p:.7g}; relative norm of the "
        f"difference {rel:.3g} (tolerance {rel_tol}); largest per-tensor "
        f"relative norm {rels[worst_rel]:.3g} ({names[worst_rel]}; "
        f"tolerance {tensor_tol}); lowest per-tensor cosine "
        f"{cos[worst_cos]:.5f} ({names[worst_cos]}; tolerance {cos_tol}); "
        f"gradient norm {float(ref):.6g}")
    if not rel <= rel_tol or not max(rels) <= tensor_tol \
            or not min(cos) >= cos_tol \
            or not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
        raise RuntimeError(f"{name}: step 1 gradients disagree with the "
                           f"plain versions")
    del g_p
    return loss_k, g_k


def drive_training(cfg, pool, static, steps, per_step, n_real, pairs=None,
                   compare=None):
    """The main path: `steps` train steps of cfg.net from
    `init_train_state_block` (seed 0; with `pairs` its GraphNet blocks take
    the paired sparse applies), each on the batch
    `pool.block_batches(step_seed=k)` gives, `payback_block` after the
    last, with the counters set to 0 just before and read just after.
    Before it, step 1's gradients with the kernels against those with the
    plain versions on the card, and, where `compare` names another
    simulator with the same weights, the distance of its step-1 gradients
    on the same batch (logged). Returns the counts, the step times and the
    peak memory."""
    from gen_fvgn_tpu_torch.training.train_block import (
        init_train_state_block, make_train_step_block)
    name = f"{cfg.net}{' paired' if pairs else ''} train"
    state, sim = init_train_state_block(cfg, seed=0, **(pairs or {}))
    train_step = make_train_step_block(cfg, sim)
    start = [p.detach().clone() for p in sim.parameters()]

    # step 1's gradients: kernels vs plain versions on the same inputs
    _, idxs = pool.block_batches(step_seed=0)[0]
    dyn = pool.gather_block(idxs)
    loss_k, g_k = hold_step1_grads(name, cfg, sim, state.norm_state, dyn,
                                   static)
    if compare is not None:
        loss_c, g_c = step1_grads(cfg, compare, state.norm_state, dyn, static,
                                  False)
        far = float(torch.sqrt(sum(((a.float() - b.float()) ** 2).sum()
                                   for a, b in zip(g_k, g_c)))
                    / torch.sqrt(sum((b.float() ** 2).sum() for b in g_c)))
        log(f"{name} step 1 against the unpaired net's step 1 on the same "
            f"batch and weights (kernels both): loss {loss_k:.7g} vs "
            f"{loss_c:.7g}; relative norm of the gradient difference "
            f"{far:.3g}")
        if not np.isfinite(far):
            raise RuntimeError(f"{name}: step 1 gradients not finite")
        del g_c
    del g_k

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_ms, uvp_new = [], None
    for k in range(steps):
        _, idxs = pool.block_batches(step_seed=k)[0]
        t0 = time.perf_counter()
        dyn = pool.gather_block(idxs)
        state, m, uvp_new = train_step(state, dyn, static)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        loss, gnorm = float(m.loss), float(m.grad_norm)
        if not np.isfinite(loss) or not np.isfinite(gnorm) or gnorm <= 0:
            raise RuntimeError(f"{name} step {k + 1}: loss {loss}, grad_norm "
                               f"{gnorm}")
        log(f"{name} step {k + 1}: loss={loss:.6g} "
            f"loss_cont={float(m.loss_cont):.6g} "
            f"loss_mom={float(m.loss_mom):.6g} "
            f"loss_press={float(m.loss_press):.6g} grad_norm={gnorm:.6g} "
            f"lr={m.lr:.3g} ms={step_ms[-1]:.2f}")
    pool.payback_block(idxs, uvp_new)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    expected = {k: per_step.get(k, 0) * steps for k in counts}
    log(f"{name}: {steps} steps, batch {BATCH}, median "
        f"{float(np.median(step_ms)):.2f} ms/step (host clock, gather and "
        f"step, ending in a synchronize); peak device memory {peak:.0f} MiB; "
        f"launches {counts}")
    if counts != expected:
        raise RuntimeError(f"{name}: launch counts {counts} != expected "
                           f"{expected}")
    moved = max(float((p.detach() - p0).abs().max())
                for p, p0 in zip(sim.parameters(), start))
    if not moved > 0 or not all(bool(torch.isfinite(p).all())
                                for p in sim.parameters()):
        raise RuntimeError(f"{name}: parameters did not move or are not "
                           f"finite")
    back = pool.gather_block(idxs).uvp
    if uvp_new.shape != back.shape or not torch.equal(
            back, uvp_new.to(back.dtype)) or bool(
            (uvp_new[:, n_real:] != 0).any()) or not bool(
            torch.isfinite(uvp_new).all()):
        raise RuntimeError(f"{name}: payback_block did not write the new "
                           f"states, or they are not finite with zero "
                           f"padded nodes")
    log(f"{name}: parameters moved by up to {moved:.3g}; payback_block wrote "
        f"the {len(idxs)} new states back; state {state.step} steps")
    return counts, step_ms, peak


def drive_hidden256(cfg, pool, static, norm_state, n_real, net, per_step,
                    train_step_counts):
    """`net` at hidden width 256: one rollout step and one train step at
    batch 2 on the same statics, weights from seed 0, each with the counters
    set to 0 just before and read just after; the rollout step and step 1's
    gradients held against the plain versions on the card. FVGN waits on
    the MLP kernels at H = 256 (K2/K3, the node MLP's parts 128 + 256;
    K4f/K4b on a 256-wide input). TransFVGN_v2 waits on exactly those and
    the Transolver kernels at C = 256: K5f/K5b with the hidden width 512
    and K6/K7 with 8 heads of 32 and 32 slices. `per_step` gives the
    rollout step's launches, `train_step_counts` the train step's."""
    from gen_fvgn_tpu_torch.solve.rollout_block import make_eval_step_block
    from gen_fvgn_tpu_torch.training.train_block import (
        init_train_state_block, make_train_step_block)
    b = 2
    hcfg = cfg.replace(net=net, hidden_size=256, batch_size=b,
                       dataset_size=b)
    name = f"{net} hidden 256"
    dyn = pool.gather_block(np.arange(b))
    state, sim = init_train_state_block(hcfg, seed=0)
    step = make_eval_step_block(hcfg, sim)
    step(norm_state, dyn, static)                  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    out = step(norm_state, dyn, static)
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {k: per_step.get(k, 0) for k in counts}
    un = out.uvp_node_new.float()
    log(f"{name} rollout step 1: batch {b}, launches {counts}; "
        f"max|uvp|={float(un.abs().max()):.4g}")
    if counts != expected or tuple(un.shape) != (b, static.pos.shape[0], 3) \
            or not bool(torch.isfinite(un).all()) \
            or bool((un[:, n_real:] != 0).any()):
        raise RuntimeError(f"{name}: rollout launches {counts} != "
                           f"{expected}, or a state not finite with zero "
                           f"padded nodes")
    plain = make_eval_step_block(hcfg, sim, plain_kernels=True)(
        norm_state, dyn, static)
    gap = float((plain.uvp_node_new.float() - un).abs().max())
    step_tol = 2e-2                    # as the main path's rollouts
    log(f"{name} rollout step 1 kernels vs plain versions on the card: "
        f"uvp_node max gap {gap:.3g} (tolerance {step_tol})")
    if not gap <= step_tol:
        raise RuntimeError(f"{name}: step 1 disagrees with the plain "
                           f"versions")
    hold_step1_grads(f"{name} train", hcfg, sim, state.norm_state, dyn,
                     static)
    train_step = make_train_step_block(hcfg, sim)
    start = [p.detach().clone() for p in sim.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, m, uvp_new = train_step(state, dyn, static)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    expected = {k: train_step_counts.get(k, 0) for k in counts}
    loss, gnorm = float(m.loss), float(m.grad_norm)
    moved = max(float((p.detach() - p0).abs().max())
                for p, p0 in zip(sim.parameters(), start))
    log(f"{name} train step 1: loss={loss:.6g} grad_norm={gnorm:.6g}; "
        f"parameters moved by up to {moved:.3g}; peak device memory "
        f"{peak:.0f} MiB; launches {counts}")
    if counts != expected or not np.isfinite(loss) or not gnorm > 0 \
            or not moved > 0 or not bool(torch.isfinite(uvp_new).all()):
        raise RuntimeError(f"{name}: train launches {counts} != {expected},"
                           f" or loss {loss}, grad_norm {gnorm}")
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from gen_fvgn_tpu_torch.ops import _cuda_build
    from gen_fvgn_tpu_torch.tools.profile_rollout import build_main_path

    # ---- phase 1: the card ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"allow_tf32(matmul)={torch.backends.cuda.matmul.allow_tf32}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    _cuda_build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_cuda_build.BUILD_SECONDS if _cuda_build.BUILD_SECONDS is not None else 'reused'})")
    for line in _cuda_build.BUILD_LOG.splitlines():
        if "registers" in line or "error" in line.lower():
            log("  ptxas: " + line.strip())

    # ---- statics of the main path ----
    t0 = time.perf_counter()
    cfg, pool, static, dyn, sim, norm_state = build_main_path(
        batch=BATCH, mesh_n=MESH_N, seed=0)
    n_pad, e_pad = static.pos.shape[0], static.edge_pos_feat.shape[0]
    mesh = pool.cases[0]["mesh"]
    n_real = mesh["node|pos"].shape[0]
    log(f"statics: {time.perf_counter() - t0:.1f} s; net {cfg.net} (hidden "
        f"{cfg.hidden_size}, {cfg.message_passing_num} blocks a processor, "
        f"{cfg.attn_heads} heads, {cfg.slice_num} slices, {cfg.mxu_dtype}); "
        f"nodes {n_real} (padded {n_pad}), faces "
        f"{mesh['face|face_node'].shape[1]} (padded {e_pad}), cells "
        f"{mesh['cell|centroid'].shape[0]} (padded "
        f"{static.cells_area.shape[0]})")

    # ---- phase 3: each kernel against its plain version (the phases of
    # hidden width 128 draw their inputs from `gen` in the same order as
    # before the width-256 phases existed; those draw from their own) ----
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.zeros(64 * 1024 * 1024, device="cuda")
    spmm_rows = check_spmm(static, flush_buf, gen)
    ln_rows = {128: check_fused_ln(n_pad, e_pad, flush_buf, gen)}
    noln_row = {128: check_fused_noln(n_pad, flush_buf, gen)}
    premlp_row = check_premlp(n_pad, flush_buf, gen)
    pool_row = check_slice_pool(static, flush_buf, gen)
    mlp_bwd_rows = {128: check_mlp_backward(n_pad, e_pad, flush_buf, gen)}
    bwd_rows = dict(mlp_bwd_rows[128],
                    **check_backward(n_pad, static, flush_buf, gen))
    pair_rows = check_pairs(static, flush_buf, gen)
    gen256 = torch.Generator(device="cuda").manual_seed(256)
    ln_rows[256] = check_fused_ln(n_pad, e_pad, flush_buf, gen256, 256)
    noln_row[256] = check_fused_noln(n_pad, flush_buf, gen256, 256)
    mlp_bwd_rows[256] = check_mlp_backward(n_pad, e_pad, flush_buf, gen256,
                                           256)
    # the Transolver kernels at C = 256 (hidden 512; 8 heads of 32, 32
    # slices), the same row counts
    premlp256 = check_premlp(n_pad, flush_buf, gen256, 256)
    pool256 = check_slice_pool(static, flush_buf, gen256, 256)
    bwd256 = check_backward(n_pad, static, flush_buf, gen256, 256)
    # the shapes repaired in this slice (their own generator)
    repaired = check_repaired_shapes(
        n_pad, static, flush_buf, torch.Generator(device="cuda").manual_seed(9))
    del flush_buf

    # ---- phase 4: the TransFVGN_v2 rollout ----
    _, hist = drive(cfg.net, cfg, sim, norm_state, dyn, static, STEPS,
                    dict(spmm=18, fused_mlp_ln=14, fused_mlp_noln=1,
                         fused_premlp_res=2, fused_slice_pool=2), n_real)

    # ---- phase 5: the FVGN rollout on the same statics ----
    fcfg = cfg.replace(net="FVGN")
    drive("FVGN", fcfg, make_simulator_block(fcfg, seed=0), norm_state, dyn,
          static, FVGN_STEPS, dict(spmm=9, fused_mlp_ln=8, fused_mlp_noln=1),
          n_real)
    del sim

    # ---- phase 6: the main path, training TransFVGN_v2 ----
    per_step = dict(spmm=48, fused_mlp_ln=14, fused_mlp_noln=1,
                    fused_premlp_res=2, fused_slice_pool=2,
                    fused_mlp_ln_bwd=14, fused_mlp_noln_bwd=1,
                    fused_premlp_res_bwd=2, fused_slice_pool_bwd=2)
    counts, _, _ = drive_training(cfg, pool, static, TRAIN_STEPS, per_step,
                                  n_real)

    # ---- phase 7: the paired path, TransFVGN_v2 with the EdgeBlocks'
    # gather pair and the NodeBlocks' node pair (K8 forward, K9 backward),
    # the same weights: rollout, then training ----
    pairs = dict(gather_pair=True, node_pair=True)
    psim = make_simulator_block(cfg, seed=0, **pairs)
    _, phist = drive(f"{cfg.net} paired", cfg, psim, norm_state, dyn, static,
                     PAIR_STEPS, dict(spmm=6, pair_sum=12, fused_mlp_ln=14,
                                      fused_mlp_noln=1, fused_premlp_res=2,
                                      fused_slice_pool=2), n_real)
    del psim
    gap = np.abs(phist[0]["uvp_node"] - hist[0]["uvp_node"])
    log(f"{cfg.net} paired rollout step 1 against the unpaired rollout's "
        f"step 1 (same weights, state and statics): uvp_node max gap "
        f"{gap.max():.3g}, median {float(np.median(gap[:, :n_real])):.3g} "
        f"(the node pair rounds its sum once, the composed form three "
        f"times; the bf16 net amplifies such ulps)")
    pair_per_step = dict(per_step, spmm=24, pair_sum=12, pair_transpose=6)
    pair_counts, _, _ = drive_training(
        cfg, pool, static, PAIR_STEPS, pair_per_step, n_real, pairs=pairs,
        compare=make_simulator_block(cfg, seed=0))

    # ---- phase 8: hidden width 256: the MLP kernels on FVGN, then every
    # kernel but the pair kernels on TransFVGN_v2 (K5 at C = 256, hidden
    # 512; K6/K7 at C = 256, 8 heads, 32 slices) ----
    fv = dict(spmm=9, fused_mlp_ln=8, fused_mlp_noln=1)
    drive_hidden256(cfg, pool, static, norm_state, n_real, "FVGN", fv,
                    dict(fv, spmm=24, fused_mlp_ln_bwd=8,
                         fused_mlp_noln_bwd=1))
    tv = dict(spmm=18, fused_mlp_ln=14, fused_mlp_noln=1,
              fused_premlp_res=2, fused_slice_pool=2)
    drive_hidden256(cfg, pool, static, norm_state, n_real, "TransFVGN_v2",
                    tv, per_step)

    # ---- phase 9: the kernels line (launches: the main path's run; the
    # pair kernels', which the main path does not run: the paired path's) --
    big = {r["op"]: r for r in spmm_rows}["nbr_r"]
    edge = {h: [r for r in rows if r["variant"].startswith("edge_mlp")][0]
            for h, rows in ln_rows.items()}
    pick = lambda r: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")}

    def entry(name, source, replaces, row, measured_on, library_ms=None,
              run=(counts, per_step)):
        return dict(name=name, route="cuda",
                    source=f"gen_fvgn_tpu_torch/csrc/{source}",
                    replaces=f"gen_fvgn_tpu/ops/{replaces}",
                    launches=run[0][name],
                    launches_per_train_step=run[1][name],
                    max_abs_err=row["max_abs_err"], **pick(row),
                    library_ms=library_ms, measured_on=measured_on,
                    **({"err_over_tolerance": row["err_over_tolerance"]}
                       if "err_over_tolerance" in row else {}))
    # no single PyTorch call computes a fused MLP chain, the pre-LN MLP
    # branch with its residual, the slice pooling, or any of their
    # backwards: library_ms is null for all but the sparse applies
    paired = (pair_counts, pair_per_step)
    gpair = pair_rows["pair_sum[gather_pair]"]
    npair = pair_rows["pair_sum[node_pair]"]
    ptrans = pair_rows["pair_transpose[node_pair]"]
    kernels = [
        entry("spmm", "spmm.cu", "pallas_spmm.py:228",
              dict(big, max_abs_err=max(r["max_abs_err"]
                                        for r in spmm_rows)),
              "nbr_r", big["library_ms"]),
        entry("fused_mlp_ln", "fused_mlp.cu", "fused_mlp.py:385",
              dict(edge[128], max_abs_err=max(r["max_abs_err"]
                                              for r in ln_rows[128])),
              "edge_mlp"),
        entry("fused_mlp_ln_bwd", "fused_mlp.cu", "fused_mlp.py:421",
              bwd_rows["fused_mlp_ln_bwd"], "edge_mlp"),
        entry("fused_mlp_noln", "fused_mlp.cu", "fused_mlp.py:960",
              noln_row[128], "decoder"),
        entry("fused_mlp_noln_bwd", "fused_mlp.cu", "fused_mlp.py:980",
              bwd_rows["fused_mlp_noln_bwd"], "decoder"),
        entry("fused_premlp_res", "fused_premlp.cu", "fused_mlp.py:747",
              premlp_row, "transolver_mlp"),
        entry("fused_premlp_res_bwd", "fused_premlp.cu", "fused_mlp.py:766",
              bwd_rows["fused_premlp_res_bwd"], "transolver_mlp"),
        entry("fused_slice_pool", "fused_slice_pool.cu",
              "fused_slice_attn.py:274", pool_row, "physics_attention"),
        entry("fused_slice_pool_bwd", "fused_slice_pool_bwd.cu",
              "fused_slice_attn.py:297", bwd_rows["fused_slice_pool_bwd"],
              "physics_attention"),
        entry("pair_sum", "pair_spmm.cu", "pallas_spmm.py:484",
              dict(gpair, max_abs_err=max(gpair["max_abs_err"],
                                          npair["max_abs_err"])),
              "gather_pair", gpair["library_ms"], paired),
        entry("pair_transpose", "pair_spmm.cu", "pallas_spmm.py:574",
              ptrans, "node_pair", ptrans["library_ms"], paired),
    ]
    kernels[-2]["node_pair"] = {k: npair[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    # K1 in every form a train step launches (the "ms" above: nbr_r at
    # full width, the parent's form, for comparison), and their sum
    kernels[0]["forms"] = [{k: r[k] for k in (
        "op", "f", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err", "launches_per_train_step",
        "launches_per_rollout_step")} for r in spmm_rows]
    kernels[0]["train_step_ms"] = sum(
        r["ms"] * r["launches_per_train_step"] for r in spmm_rows)
    # the same four kernels at hidden width 256 (same forms and method)
    wide = dict(fused_mlp_ln=edge[256], fused_mlp_noln=noln_row[256],
                **{k: mlp_bwd_rows[256][k]
                   for k in ("fused_mlp_ln_bwd", "fused_mlp_noln_bwd")},
                fused_premlp_res=premlp256, fused_slice_pool=pool256,
                **bwd256)
    for k in kernels:
        if k["name"] in bwd_rows and "design_bytes" in bwd_rows[k["name"]]:
            k["design_bytes"] = bwd_rows[k["name"]]["design_bytes"]
    for k in kernels:
        if k["name"] in wide:
            k["hidden_256"] = {f: wide[k["name"]][f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    for k in kernels:
        if k["name"] in repaired:
            k["repaired_shapes"] = {sh: {f: r[f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                for sh, r in repaired[k["name"]].items()}
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise RuntimeError(f"the path that should run them launched no "
                           f"{missing}")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
