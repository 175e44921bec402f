#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `gen_fvgn_tpu_torch/csrc/` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes of the main path, then drives two paths through `rollout_block` on
the 101x101-node synthetic cavity at batch 8, with weights from
torch.Generator().manual_seed(0):

  * the main path: 5 steps of the Config's default net, TransFVGN_v2
    (hidden 128, 2 processors of 3 message-passing blocks and a Transolver
    block each, 8 heads, 32 slices, bf16 stream); per step 18 spmm, 14
    fused_mlp_ln, 1 fused_mlp_noln, 2 fused_premlp_res and 2
    fused_slice_pool launches;
  * the FVGN net (3 message-passing blocks, no attention), 3 steps; per
    step 9 spmm, 8 fused_mlp_ln, 1 fused_mlp_noln.

Each path's launch counters are set to 0 just before it and read just
after; the script checks them, finite outputs, zero padded nodes, a state
that moves, and step 1 against the same step run with the kernels' plain
versions on the card.

Needs one CUDA card and nvcc; exits non-zero without them, and on any phase
that fails. float32 products run in full float32: TF32 is switched off
here for matmuls and cuDNN.

Timing: CUDA events around single launches after a warm-up, median of 20,
with a 256 MB buffer rewritten between launches so that each launch finds
the 50 MB L2 cold.
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

BATCH, STEPS, FVGN_STEPS, MESH_N = 8, 5, 3, 100
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


def check_spmm(static, flush_buf, gen):
    """K1 on adj, nbr_r, nbr_s at [8, n_in, 128] bf16."""
    from gen_fvgn_tpu_torch.ops.spmm import spmm, spmm_reference
    rows = []
    for name in ("adj", "nbr_r", "nbr_s"):
        op = getattr(static.ops, name).fwd
        x = torch.randn(BATCH, op.n_in, 128, generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = spmm(op, x)
        ref = spmm_reference(op, x)
        torch.cuda.synchronize()
        max_abs, max_rel = err_stats(out, ref)
        # integer weights, float32 accumulation in another order: at most
        # one bf16 rounding of the output
        tol_rel = BF16_EPS
        bad = ((out.float() - ref.float()).abs()
               > tol_rel * ref.float().abs() + 1e-6)
        if bool(bad.any()) or out.dtype != torch.bfloat16:
            raise RuntimeError(f"spmm[{name}] disagrees with spmm_reference: "
                               f"max abs {max_abs}, max rel {max_rel}")
        n_real = int((op.crow[1:] > op.crow[:-1]).nonzero().max()) + 1
        if bool((out[:, n_real:] != 0).any()):
            raise RuntimeError(f"spmm[{name}]: padded rows are not zero")
        # the library call: torch.sparse CSR @ dense on the same values, the
        # batch folded into the columns ([n_in, B*128]) outside the timing
        a16 = torch.sparse_csr_tensor(op.crow, op.col,
                                      op.val.to(torch.bfloat16),
                                      size=(op.n_out, op.n_in))
        xf = x.permute(1, 0, 2).reshape(op.n_in, BATCH * 128).contiguous()
        lib = torch.sparse.mm(a16, xf).reshape(op.n_out, BATCH, 128)
        lib_abs, _ = err_stats(lib.permute(1, 0, 2), ref)
        ms = median_ms(lambda: spmm(op, x), flush_buf)
        plain_ms = median_ms(lambda: spmm_reference(op, x), flush_buf)
        library_ms = median_ms(lambda: torch.sparse.mm(a16, xf), flush_buf)
        used_rows = int(torch.unique(op.col).numel())
        moved = (BATCH * used_rows * 128 * 2 + nbytes(out)
                 + nbytes(op.crow, op.col, op.val))
        # float32 accumulation of the products: CUDA cores
        bound_ms, bound_by = bound(moved, 0.0,
                                   f32_flops=2.0 * op.nnz * BATCH * 128)
        rows.append(dict(op=name, nnz=op.nnz, n_out=op.n_out, n_in=op.n_in,
                         max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"kernel spmm[{name}] [{BATCH},{op.n_in},128]->[{BATCH},"
            f"{op.n_out},128] bf16 nnz={op.nnz}: max_abs_err={max_abs:.3g} "
            f"max_rel_err={max_rel:.3g} (tolerance {tol_rel:.3g} relative; "
            f"library vs plain max_abs {lib_abs:.3g}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={rows[-1]['bound_ms']:.4f}")
    return rows


def mlp_weights(gen, k_total, d_out):
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return dict(w1=g(k_total, 128) / max(k_total, 1) ** 0.5, b1=0.1 * g(128),
                w2=g(128, 128) / 128 ** 0.5, b2=0.1 * g(128),
                w3=g(128, d_out) / 128 ** 0.5, b3=0.1 * g(d_out),
                gamma=1.0 + 0.1 * g(d_out), beta=0.1 * g(d_out))


def check_fused_ln(n_pad, e_pad, flush_buf, gen):
    """K2 in the variants of the main path."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (fused_mlp_ln,
                                                  fused_mlp_ln_reference)
    bf = torch.bfloat16
    rnd = lambda m, k: torch.randn(m, k, generator=gen, device="cuda").to(bf)
    mn, me = BATCH * n_pad, BATCH * e_pad
    variants = [
        # name, M, part widths, has pre, w1 rows, res_idx, res_dual
        ("node_encoder(pres-only)", mn, [], True, 12, None, False),
        ("edge_encoder(pres-only)", me, [], True, 15, None, False),
        ("edge_mlp(part+pre,dual)", me, [128], True, 384, 0, True),
        ("node_mlp(parts 64+128,res)", mn, [64, 128], False, 192, 1, False),
    ]
    rows = []
    for name, m, widths, has_pre, k_total, res_idx, res_dual in variants:
        w = mlp_weights(gen, k_total, 128)
        parts = [rnd(m, k) for k in widths]
        k1 = sum(widths)
        w1s, off = [], k_total - k1        # the parts own the LAST rows of W1
        for k in widths:
            w1s.append(w["w1"][off:off + k].to(bf).contiguous())
            off += k
        pres = (rnd(m, 128),) if has_pre else ()
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
                    f"fused_mlp_ln[{name}] disagrees with its plain version: "
                    f"max abs {a} > {t}")
            max_abs, max_rel, tol = max(max_abs, a), max(max_rel, rl), max(tol, t)
        ms = median_ms(run, flush_buf)
        plain_ms = median_ms(run_ref, flush_buf, iters=5, warmup=1)
        moved = (nbytes(*parts, *pres, *outs, *w1s, args[3], args[5])
                 + 4 * 5 * 128)
        bound_ms, bound_by = bound(
            moved, 2.0 * m * (k1 * 128 + 128 * 128 + 128 * 128))
        rows.append(dict(variant=name, m=m, max_abs_err=max_abs,
                         max_rel_err=max_rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"kernel fused_mlp_ln[{name}] M={m} bf16: "
            f"max_abs_err={max_abs:.3g} max_rel_err={max_rel:.3g} "
            f"(tolerance {tol:.3g} abs = 2 bf16 ulps of the output scale) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={rows[-1]['bound_ms']:.4f}")
    return rows


def check_fused_noln(n_pad, flush_buf, gen):
    """K4f at the decoder's shape: [8*N, 128] bf16 -> [8*N, 3]."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (fused_mlp_noln,
                                                  fused_mlp_noln_reference)
    bf = torch.bfloat16
    m = BATCH * n_pad
    w = mlp_weights(gen, 128, 3)
    x = torch.randn(m, 128, generator=gen, device="cuda").to(bf)
    args = (x, w["w1"].to(bf), w["b1"], w["w2"].to(bf), w["b2"],
            w["w3"].to(bf).contiguous(), w["b3"])
    out, ref = fused_mlp_noln(*args), fused_mlp_noln_reference(*args)
    torch.cuda.synchronize()
    max_abs, max_rel = err_stats(out, ref)
    tol = ulps_of_scale(ref, 2)
    if max_abs > tol or tuple(out.shape) != (m, 3) or out.dtype != bf:
        raise RuntimeError(f"fused_mlp_noln disagrees with its plain version:"
                           f" max abs {max_abs} > {tol}")
    ms = median_ms(lambda: fused_mlp_noln(*args), flush_buf)
    plain_ms = median_ms(lambda: fused_mlp_noln_reference(*args), flush_buf,
                         iters=5, warmup=1)
    moved = nbytes(x, out, args[1], args[3], args[5]) + 4 * (128 + 128 + 3)
    bound_ms, bound_by = bound(moved,
                               2.0 * m * (128 * 128 + 128 * 128 + 128 * 3))
    row = dict(m=m, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel fused_mlp_noln M={m} bf16 -> [M,3]: max_abs_err={max_abs:.3g}"
        f" max_rel_err={max_rel:.3g} (tolerance {tol:.3g} abs = 2 bf16 ulps "
        f"of the output scale) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={row['bound_ms']:.4f}")
    return row


def check_premlp(n_pad, flush_buf, gen):
    """K5f at the Transolver block's shape: x [8*N, 128] bf16, hidden 256."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (fused_premlp_res,
                                                  fused_premlp_res_reference)
    bf = torch.bfloat16
    m = BATCH * n_pad
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (2.0 * g(m, 128) + 0.5).to(bf)
    args = (x, 1.0 + 0.1 * g(128), 0.1 * g(128),
            (g(128, 256) / 128 ** 0.5).to(bf), 0.1 * g(256),
            (g(256, 128) / 256 ** 0.5).to(bf), 0.1 * g(128))
    out, ref = fused_premlp_res(*args), fused_premlp_res_reference(*args)
    torch.cuda.synchronize()
    max_abs, max_rel = err_stats(out, ref)
    # float32 sums in another order and last-bit tanhf/sqrtf differences
    # can move one bf16 rounding of u, h or the output by one step
    tol = ulps_of_scale(ref, 2)
    if max_abs > tol or tuple(out.shape) != (m, 128) or out.dtype != bf \
            or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"fused_premlp_res disagrees with its plain "
                           f"version: max abs {max_abs} > {tol}")
    ms = median_ms(lambda: fused_premlp_res(*args), flush_buf)
    plain_ms = median_ms(lambda: fused_premlp_res_reference(*args),
                         flush_buf, iters=5, warmup=1)
    moved = nbytes(x, out, args[3], args[5]) + 4 * (3 * 128 + 256)
    bound_ms, bound_by = bound(moved, 2.0 * m * (128 * 256 + 256 * 128))
    row = dict(m=m, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel fused_premlp_res M={m} bf16 [M,128]->[M,128] hidden 256: "
        f"max_abs_err={max_abs:.3g} max_rel_err={max_rel:.3g} (tolerance "
        f"{tol:.3g} abs = 2 bf16 ulps of the output scale) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def check_slice_pool(static, flush_buf, gen):
    """K6 at the attention's shape: x [8, N, 128] bf16, the static node
    mask, 8 heads of 16, 32 slices, temperature 0.5."""
    from gen_fvgn_tpu_torch.ops.fused_slice_attn import (
        fused_slice_pool_kernel, fused_slice_pool_reference, slice_logits,
        slice_w_tolerance)
    bf = torch.bfloat16
    n = static.pos.shape[0]
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = g(BATCH, n, 128).to(bf)
    mask = static.node_mask.to(torch.float32)
    args = (x, mask, (g(128, 128) / 128 ** 0.5).to(bf), 0.1 * g(128),
            (g(128, 128) / 128 ** 0.5).to(bf), 0.1 * g(128),
            (g(16, 32) / 4.0).to(bf), 0.1 * g(32),
            torch.full((8,), 2.0, device="cuda"))
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
            raise RuntimeError(f"fused_slice_pool[{name}] disagrees with its "
                               f"plain version: max abs {a} > {t}")
        errs.append(a)
        tols.append(t)
    if w_far >= 1e-4:
        raise RuntimeError(f"fused_slice_pool: a share {w_far} of the slice "
                           f"weights is more than 2^-7 off")
    ms = median_ms(lambda: fused_slice_pool_kernel(*args), flush_buf)
    plain_ms = median_ms(lambda: fused_slice_pool_reference(*args),
                         flush_buf, iters=5, warmup=1)
    rows = BATCH * n
    moved = nbytes(x, mask, *outs, args[2], args[4], args[6]) \
        + 4 * (2 * 128 + 32 + 8)
    # the projections and the logits take bf16 operands (tensor cores); the
    # pooling takes float32 w*mask and fx (CUDA cores): per-head blocks only
    bound_ms, bound_by = bound(
        moved, 2.0 * rows * (2 * 128 * 128 + 8 * 16 * 32),
        f32_flops=2.0 * rows * 8 * 32 * 16)
    row = dict(m=rows, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel fused_slice_pool x [{BATCH},{n},128] bf16 -> slice_w "
        f"[{BATCH},{n},256] bf16, tokens [{BATCH},8,32,16], norm "
        f"[{BATCH},8,32]: max_abs_err slice_w={errs[0]:.3g} "
        f"tokens={errs[1]:.3g} norm={errs[2]:.3g} (tolerance "
        f"{tols[0]:.3g} for a flipped logit rounding at max|logit| "
        f"{l_max:.3g}, {tols[1]:.3g} and {tols[2]:.3g} = 1e-3 of the scale; "
        f"share of weights more than 2^-7 off {w_far:.3g}, limit 1e-4); two "
        f"runs bitwise equal; ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def launch_counts():
    from gen_fvgn_tpu_torch.ops import fused_mlp, fused_slice_attn, spmm
    return dict(spmm=spmm.LAUNCHES, fused_mlp_ln=fused_mlp.LAUNCHES_LN,
                fused_mlp_noln=fused_mlp.LAUNCHES_NOLN,
                fused_premlp_res=fused_mlp.LAUNCHES_PREMLP,
                fused_slice_pool=fused_slice_attn.LAUNCHES)


def zero_counts():
    from gen_fvgn_tpu_torch.ops import fused_mlp, fused_slice_attn, spmm
    spmm.LAUNCHES = 0
    fused_mlp.LAUNCHES_LN = fused_mlp.LAUNCHES_NOLN = 0
    fused_mlp.LAUNCHES_PREMLP = 0
    fused_slice_attn.LAUNCHES = 0


def drive(name, cfg, sim, norm_state, dyn, static, steps, per_step, n_real):
    """`steps` rollout steps of `sim` with the counters set to 0 just before
    and read just after; then step 1 again with the plain versions on the
    card. Returns the counts of the rollout."""
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
    expected = {k: v * steps for k, v in per_step.items()}
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

    # ---- phase 3: each kernel against its plain version ----
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.zeros(64 * 1024 * 1024, device="cuda")
    spmm_rows = check_spmm(static, flush_buf, gen)
    ln_rows = check_fused_ln(n_pad, e_pad, flush_buf, gen)
    noln_row = check_fused_noln(n_pad, flush_buf, gen)
    premlp_row = check_premlp(n_pad, flush_buf, gen)
    pool_row = check_slice_pool(static, flush_buf, gen)
    del flush_buf

    # ---- phase 4: the main path, TransFVGN_v2 ----
    counts = drive(cfg.net, cfg, sim, norm_state, dyn, static, STEPS,
                   dict(spmm=18, fused_mlp_ln=14, fused_mlp_noln=1,
                        fused_premlp_res=2, fused_slice_pool=2), n_real)

    # ---- phase 5: the FVGN net on the same statics ----
    fcfg = cfg.replace(net="FVGN")
    drive("FVGN", fcfg, make_simulator_block(fcfg, seed=0), norm_state, dyn,
          static, FVGN_STEPS,
          dict(spmm=9, fused_mlp_ln=8, fused_mlp_noln=1, fused_premlp_res=0,
               fused_slice_pool=0), n_real)

    # ---- phase 6: the kernels line (launches: the main path's run) ----
    big = {r["op"]: r for r in spmm_rows}["nbr_r"]
    edge = [r for r in ln_rows if r["variant"].startswith("edge_mlp")][0]
    pick = lambda r: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")}
    kernels = [
        dict(name="spmm", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/spmm.cu",
             replaces="gen_fvgn_tpu/ops/pallas_spmm.py:228",
             launches=counts["spmm"],
             max_abs_err=max(r["max_abs_err"] for r in spmm_rows),
             **pick(big), library_ms=big["library_ms"], measured_on="nbr_r"),
        dict(name="fused_mlp_ln", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/fused_mlp.cu",
             replaces="gen_fvgn_tpu/ops/fused_mlp.py:385",
             launches=counts["fused_mlp_ln"],
             max_abs_err=max(r["max_abs_err"] for r in ln_rows),
             **pick(edge), library_ms=None, measured_on="edge_mlp"),
        dict(name="fused_mlp_noln", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/fused_mlp.cu",
             replaces="gen_fvgn_tpu/ops/fused_mlp.py:960",
             launches=counts["fused_mlp_noln"],
             max_abs_err=noln_row["max_abs_err"], **pick(noln_row),
             library_ms=None, measured_on="decoder"),
        # no single PyTorch call computes the pre-LN MLP branch with its
        # residual, nor the slice pooling: library_ms is null for both
        dict(name="fused_premlp_res", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/fused_premlp.cu",
             replaces="gen_fvgn_tpu/ops/fused_mlp.py:747",
             launches=counts["fused_premlp_res"],
             max_abs_err=premlp_row["max_abs_err"], **pick(premlp_row),
             library_ms=None, measured_on="transolver_mlp"),
        dict(name="fused_slice_pool", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/fused_slice_pool.cu",
             replaces="gen_fvgn_tpu/ops/fused_slice_attn.py:274",
             launches=counts["fused_slice_pool"],
             max_abs_err=pool_row["max_abs_err"], **pick(pool_row),
             library_ms=None, measured_on="physics_attention"),
    ]
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise RuntimeError(f"the main path launched no {missing}")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
