#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `gen_fvgn_tpu_torch/csrc/` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes of the main path, then drives the main path: 5 rollout steps of the
FVGN simulator (hidden 128, 3 message-passing blocks, bf16 stream, batch 8)
on the 101x101-node synthetic cavity through `rollout_block`, with weights
from torch.Generator().manual_seed(0). It checks the launch counters (per
step 9 spmm, 8 fused_mlp_ln, 1 fused_mlp_noln), finite outputs, and step 1
against the same step run with the kernels' plain versions on the card.

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

BATCH, STEPS, MESH_N = 8, 5, 100
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
        flops = 2.0 * op.nnz * BATCH * 128
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
        rows.append(dict(op=name, nnz=op.nnz, n_out=op.n_out, n_in=op.n_in,
                         max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations"))
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
        flops = 2.0 * m * (k1 * 128 + 128 * 128 + 128 * 128)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
        rows.append(dict(variant=name, m=m, max_abs_err=max_abs,
                         max_rel_err=max_rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations"))
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
    flops = 2.0 * m * (128 * 128 + 128 * 128 + 128 * 3)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    row = dict(m=m, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
               plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"kernel fused_mlp_noln M={m} bf16 -> [M,3]: max_abs_err={max_abs:.3g}"
        f" max_rel_err={max_rel:.3g} (tolerance {tol:.3g} abs = 2 bf16 ulps "
        f"of the output scale) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={row['bound_ms']:.4f}")
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gen_fvgn_tpu_torch.ops import _cuda_build
    from gen_fvgn_tpu_torch.ops import fused_mlp as fused_mod
    from gen_fvgn_tpu_torch.ops import spmm as spmm_mod
    from gen_fvgn_tpu_torch.solve.rollout_block import (make_eval_step_block,
                                                        rollout_block)
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
    log(f"statics: {time.perf_counter() - t0:.1f} s; nodes {n_real} "
        f"(padded {n_pad}), faces {mesh['face|face_node'].shape[1]} (padded "
        f"{e_pad}), cells {mesh['cell|centroid'].shape[0]} (padded "
        f"{static.cells_area.shape[0]})")

    # ---- phase 3: each kernel against its plain version ----
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.zeros(64 * 1024 * 1024, device="cuda")
    spmm_rows = check_spmm(static, flush_buf, gen)
    ln_rows = check_fused_ln(n_pad, e_pad, flush_buf, gen)
    noln_row = check_fused_noln(n_pad, flush_buf, gen)

    # ---- phase 4: the rollout ----
    step_fn = make_eval_step_block(cfg, sim)
    step_fn(norm_state, dyn, static)            # warm-up, not counted
    torch.cuda.synchronize()
    spmm_mod.LAUNCHES = 0
    fused_mod.LAUNCHES_LN = 0
    fused_mod.LAUNCHES_NOLN = 0
    stamps = [time.perf_counter()]
    hist = rollout_block(
        cfg, sim, norm_state, dyn, static, STEPS,
        export_fn=lambda t, un, uc, rec: stamps.append(time.perf_counter()))
    counts = dict(spmm=spmm_mod.LAUNCHES, fused_mlp_ln=fused_mod.LAUNCHES_LN,
                  fused_mlp_noln=fused_mod.LAUNCHES_NOLN)
    step_ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:])]
    for rec, ms in zip(hist, step_ms):
        for key in ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press"):
            if rec[key].shape != (BATCH,) or not np.isfinite(rec[key]).all():
                raise RuntimeError(f"step {rec['step']}: {key} not finite")
        un, uc = rec["uvp_node"], rec["uvp_cell"]
        if un.shape != (BATCH, n_pad, 3) or not np.isfinite(un).all() \
                or not np.isfinite(uc).all():
            raise RuntimeError(f"step {rec['step']}: state not finite or of "
                               f"the wrong shape {un.shape}")
        if np.abs(un[:, n_real:]).max() != 0:
            raise RuntimeError(f"step {rec['step']}: padded nodes not zero")
        log(f"rollout step {rec['step']}: loss_cont={rec['loss_cont'].mean():.6g}"
            f" loss_mom_x={rec['loss_mom_x'].mean():.6g} "
            f"loss_mom_y={rec['loss_mom_y'].mean():.6g} "
            f"loss_press={rec['loss_press'].mean():.6g} "
            f"max|uvp|={np.abs(un).max():.4g} ms={ms:.2f}")
    expected = dict(spmm=9 * STEPS, fused_mlp_ln=8 * STEPS,
                    fused_mlp_noln=1 * STEPS)
    log(f"rollout: {STEPS} steps, batch {BATCH}, median "
        f"{float(np.median(step_ms)):.2f} ms/step (host clock, state copied "
        f"to the host each step); launches {counts}")
    if counts != expected:
        raise RuntimeError(f"launch counts {counts} != expected {expected}")
    if np.abs(hist[-1]["uvp_node"] - hist[0]["uvp_node"]).max() == 0:
        raise RuntimeError("the rollout did not move the state")

    # step 1 again with the kernels' plain versions on the card
    plain = make_eval_step_block(cfg, sim, plain_kernels=True)(
        norm_state, dyn, static)
    if (spmm_mod.LAUNCHES, fused_mod.LAUNCHES_LN,
            fused_mod.LAUNCHES_NOLN) != tuple(expected.values()):
        raise RuntimeError("the plain step launched a kernel")
    gap = np.abs(plain.uvp_node_new.cpu().numpy() - hist[0]["uvp_node"])
    loss_gap = float(np.abs(plain.loss_cont.cpu().numpy().reshape(-1)
                            - hist[0]["loss_cont"]).max()
                     / np.abs(hist[0]["loss_cont"]).max())
    # a few bf16 roundings of a backbone output of scale 1 (2^-8 each),
    # smoothed over a cell's nodes
    step_tol = 2e-2
    log(f"step 1 kernels vs plain versions on the card: uvp_node max gap "
        f"{gap.max():.3g}, median {float(np.median(gap[:, :n_real])):.3g} "
        f"(tolerance {step_tol}); loss_cont rel gap {loss_gap:.3g}")
    if not gap.max() <= step_tol or not loss_gap <= 5e-2:
        raise RuntimeError("step 1 disagrees with the plain versions")

    # ---- phase 5: the kernels line ----
    big = {r["op"]: r for r in spmm_rows}["nbr_r"]
    edge = [r for r in ln_rows if r["variant"].startswith("edge_mlp")][0]
    kernels = [
        dict(name="spmm", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/spmm.cu",
             replaces="gen_fvgn_tpu/ops/pallas_spmm.py:228",
             launches=counts["spmm"],
             max_abs_err=max(r["max_abs_err"] for r in spmm_rows),
             ms=big["ms"], plain_ms=big["plain_ms"],
             bound_ms=big["bound_ms"], bound_by=big["bound_by"],
             library_ms=big["library_ms"], measured_on="nbr_r"),
        dict(name="fused_mlp_ln", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/fused_mlp.cu",
             replaces="gen_fvgn_tpu/ops/fused_mlp.py:385",
             launches=counts["fused_mlp_ln"],
             max_abs_err=max(r["max_abs_err"] for r in ln_rows),
             ms=edge["ms"], plain_ms=edge["plain_ms"],
             bound_ms=edge["bound_ms"], bound_by=edge["bound_by"],
             library_ms=None, measured_on="edge_mlp"),
        dict(name="fused_mlp_noln", route="cuda",
             source="gen_fvgn_tpu_torch/csrc/fused_mlp.cu",
             replaces="gen_fvgn_tpu/ops/fused_mlp.py:960",
             launches=counts["fused_mlp_noln"],
             max_abs_err=noln_row["max_abs_err"], ms=noln_row["ms"],
             plain_ms=noln_row["plain_ms"], bound_ms=noln_row["bound_ms"],
             bound_by=noln_row["bound_by"], library_ms=None,
             measured_on="decoder"),
    ]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
