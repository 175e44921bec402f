#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `gen_fvgn_tpu_torch/csrc/` with nvcc,
holds each kernel, forward and backward, against its plain PyTorch version
on the card at the shapes of the main path (K1 in each form a train step
launches, `SPMM_FORMS`, the node aggregation's 64-column windows among
them; K2-K7 at hidden width 128 and again at 256; the Transolver kernels
K5-K7 also at the shapes the JAX package fuses beyond the nets', C 768,
1024, 1152 and 2048, (C, H, G) = (128, 16, 8), (512, 4, 128), (384, 6,
64), (1152, 8, 32), (2048, 16, 8), at batch 2, and one TransolverBlock at
hidden 1152 forward and backward against its plain versions; the paired
sparse applies K8 and K9 at the paired path's), then drives ten paths
on the 101x101-node synthetic cavity at batch 8, with weights from
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
    launches;
  * the training run: `train()` (training/loop.py) with the main path's
    Config on two cases of the same cavity, the main path's Navier-Stokes
    case and a wave case (dt 0.05, source strength 0.02): 16 environments,
    8 a case, batch 8, 20 inner steps, 3 epochs (120 train steps), a
    boundary-condition re-roll after epochs 1 and 2 exported to Tecplot,
    the wave sources after every epoch, checkpoint slots 0 and 2. Checks
    the steps and epochs, the three rows of Loss_monitor.dat (finite, lr as
    `step_exp_lr`), the re-rolled slots and their exports, that the
    injections moved the wave environments' p and nothing else, and the
    launches (120 x the main path's per step); then 2.state restored into
    a fresh state (bit-equal to the run's) and one more step from each on
    the same batch (the same bits); then the per-epoch work and a
    checkpoint save timed alone;
  * the solves, from the training run's final state on its Navier-Stokes
    case: `solve_adam_block` at batch 1, 2 time steps x 20 inner steps
    (its first step's gradients held against the plain versions on the
    card; launches 40 x a train step's plus two forwards), the chunked form
    at batch 12 with microbatch 8 (two chunks, four pad rows; 1 x 3) held
    against the same solve unchunked, and `solve_lbfgs_block` at batch 1,
    memory 100, 5 iterations (launches a train step's per function
    evaluation plus one forward; the evaluations per iteration logged).
    Each loss must fall;
  * the CLIs, as a user starts the port: two COMSOL case directories of
    10,201 nodes written by `tools/case_files.py` (the main path's
    lid-driven quad cavity; a triangle cavity of 20,000 cells with an
    inflow, an outflow and other coefficients), `load_case` timed on each,
    `scripts.pre_train.main` at the Config defaults (batch 8, 16
    environments, 2 epochs of 2 inner steps) with per-case and with
    mixed-case batches (finite losses, the loss monitor, checkpoint slots
    0 and 1, launches the train steps' or the mixed steps' groups' x the
    main path's per step), the summed gradients of one mixed step of two
    groups held against the plain versions on the card, and
    `scripts.solve.main --engine block` from the mixed run's checkpoint in
    the modes rollout, adam and lbfgs, 2 time steps of 2 inner steps
    (exports and launches checked).

  * the segment engine (the JAX package's default, phase "segment"), at the
    Config defaults and batch 8 with its own pool (padded to multiples of
    128: 10,240 nodes and 20,224 faces): a 3-step `rollout` (per step 14
    fused_mlp_ln, 1 fused_mlp_noln, 2 fused_premlp_res and 2
    fused_slice_pool launches and no spmm or pair kernel), step 1's
    gradients against the plain versions, the run-to-run spread of its
    atomic segment sums, 3 train steps of `make_train_step` (14 + 14,
    1 + 1, 2 + 2, 2 + 2 launches a step), one time step of `solve_adam` at
    batch 1 (20 inner steps), and on the 100 x 100-node cavity (10,112
    nodes, 19,840 faces: odd multiples of 128, where the slice attention
    takes its plain form, as in JAX) two rollout steps and a train step
    with step 1 held against the plain versions; before it, K2 and K3 at the
    segment engine's two part forms (one plain 384-wide part; one 192-wide
    part the wrapper pads to 256), against their plain versions. The CLI
    phase also runs `scripts.solve.main` with no `--engine` (the segment
    engine) on both case directories in the three modes.

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
itself; K5f, K8 and K9, redesigned for this card, carry their kernels'
registers and spill bytes from nvcc's -Xptxas -v ("registers": K5f's
strip kernel `premlp_rows`, K8's `pair_sum_kernel` and K9's
`pair_transpose_kernel` over their instantiations and at the main forms'
bf16 16-byte vectors).

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

import copy
import functools
import json
import re
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


def ptxas_usage(build_log, fragment):
    """Registers and spill bytes of each compiled kernel whose (mangled)
    name holds `fragment`, from nvcc's `-Xptxas -v` output: a list of
    dicts (function, registers, spill_stores, spill_loads)."""
    found, fn, spill = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            if fragment in fn:
                found.append(dict(function=fn, registers=int(m.group(1)),
                                  spill_stores=spill[0],
                                  spill_loads=spill[1]))
            fn = None
    return found


def register_summary(build_log, fragment, main=()):
    """The kernels' registers for the kernels line: the largest count and
    spill over every instantiation of `fragment`, and each instantiation
    whose mangled name also holds one of `main` (the main path's)."""
    usage = ptxas_usage(build_log, fragment)
    if not usage:
        raise RuntimeError(f"no -Xptxas -v lines for {fragment} in the build "
                           f"log")
    return dict(instantiations=len(usage),
                max_registers=max(u["registers"] for u in usage),
                max_spill_bytes=max(u["spill_stores"] + u["spill_loads"]
                                    for u in usage),
                main={m: [u for u in usage if m in u["function"]]
                      for m in main})


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
                     batch=BATCH, nodes=None):
    """K6 at the attention's shape: x [batch, N, c] bf16, the static node
    mask, `heads` heads of c / heads, `slices` slices, temperature 0.5; N
    the first `nodes` nodes where given."""
    from gen_fvgn_tpu_torch.ops.fused_slice_attn import (
        fused_slice_pool_kernel, fused_slice_pool_reference, slice_logits,
        slice_w_tolerance)
    bf = torch.bfloat16
    n = nodes or static.pos.shape[0]
    d, hg = c // heads, heads * slices
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = g(batch, n, c).to(bf)
    mask = static.node_mask[:n].to(torch.float32)
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
                   slices=32, batch=BATCH, premlp=True, pool=True,
                   nodes=None):
    """K5b at the Transolver MLP's shape (x [batch*N, c], hidden 2c) and K7
    at the attention's (x [batch, N, c], `heads` heads, `slices` slices),
    each against its plain version; rows batch-major, `batch` lanes.
    Beside each bound (the function's own bytes and operations) the bytes
    the kernel's two passes move: the row pass's reads and writes, its bf16
    rows read again by the weight-gradient pass once per output tile they
    feed. `premlp` / `pool` leave out K5b / K7; K7 takes the first `nodes`
    nodes where given."""
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
            f"fused_premlp_res_bwd C={c} M={m}",
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
        n = nodes or static.pos.shape[0]
        d, hg = c // heads, heads * slices
        x = g(batch, n, c).to(bf)
        mask = static.node_mask[:n].to(torch.float32)
        cots = (g(batch, n, hg).to(bf), g(batch, heads, slices, d),
                g(batch, heads, slices))
        args = (x, mask, (g(c, c) / c ** 0.5).to(bf), 0.1 * g(c),
                (g(c, c) / c ** 0.5).to(bf), 0.1 * g(c),
                (g(d, slices) / d ** 0.5).to(bf), 0.1 * g(slices),
                torch.full((heads,), 2.0, device="cuda"), *cots)
        out, row = hold_backward(
            f"fused_slice_pool_bwd C={c} H={heads} G={slices} x "
            f"[{batch},{n},{c}]",
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


# the Transolver kernels' shapes beyond the nets': (C of K5f/K5b), then
# (C, H, G, nodes a lane) of K6/K7; the run-time paths above C = 1024 run
# on a quarter of the nodes, so that the script stays within its limit
REPAIRED_PREMLP = (768, 1024, 1152, 2048)
REPAIRED_POOL = ((128, 16, 8, None), (512, 4, 128, None), (384, 6, 64, None),
                 (1152, 8, 32, 2560), (2048, 16, 8, 2560))


def check_repaired_shapes(n_pad, static, flush_buf, gen):
    """The Transolver kernels at shapes the JAX package fuses beyond the
    nets', at batch 2 (right, not fast): K5f/K5b at C 768, 1024, 1152 and
    2048 (hidden 2C; as passes through device memory) on the main path's
    rows; K6/K7 at (C, H, G) = (128, 16, 8), (512, 4, 128) and (384, 6, 64)
    on the main path's rows and (1152, 8, 32) and (2048, 16, 8) on 2,560
    nodes a lane (their run-time paths), each held against its plain
    version as the main shapes are. Returns {kernel: {shape: row}}."""
    out = {k: {} for k in ("fused_premlp_res", "fused_premlp_res_bwd",
                           "fused_slice_pool", "fused_slice_pool_bwd")}
    for c in REPAIRED_PREMLP:
        out["fused_premlp_res"][f"C{c}"] = check_premlp(
            n_pad, flush_buf, gen, c, batch=2)
        out["fused_premlp_res_bwd"][f"C{c}"] = check_backward(
            n_pad, static, flush_buf, gen, c, batch=2,
            pool=False)["fused_premlp_res_bwd"]
    for c, h, gs, nodes in REPAIRED_POOL:
        key = f"C{c}-H{h}-G{gs}"
        out["fused_slice_pool"][key] = check_slice_pool(
            static, flush_buf, gen, c, h, gs, batch=2, nodes=nodes)
        out["fused_slice_pool_bwd"][key] = check_backward(
            n_pad, static, flush_buf, gen, c, h, gs, batch=2,
            premlp=False, nodes=nodes)["fused_slice_pool_bwd"]
    return out


def check_wide_block(c=1152, heads=8, slices=32, batch=2, nodes=2048):
    """One TransolverBlock at hidden c (`heads` heads, `slices` slices,
    bf16; a width above C = 1024, where the kernels once raised), random
    weights and biases from a seed, forward and backward with the kernels (one
    launch each of K5f, K6, K5b, K7) against the same with the plain
    versions on the same inputs. Limits as step 1's gradients on the main
    path: each of the output, dx and the parameters' gradients within a
    relative norm of 3e-2 of the plain version's, cosine at least 0.999."""
    from gen_fvgn_tpu_torch.models.transolver import TransolverBlock
    from gen_fvgn_tpu_torch.ops import plain_versions
    gen = torch.Generator().manual_seed(c)
    block = TransolverBlock(c, heads, slices, dtype=torch.bfloat16,
                            generator=gen)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    block = block.to("cuda")
    x0 = torch.randn(batch, nodes, c, generator=gen).to(torch.bfloat16)
    dy = torch.randn(batch, nodes, c, generator=gen)
    x0, dy = x0.to("cuda"), dy.to("cuda")
    mask = (torch.arange(nodes, device="cuda") < nodes - 100).float()
    names = ["out", "dx"] + [n for n, _ in block.named_parameters()]

    def run():
        block.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        y = block(x, mask)
        (y.float() * dy).sum().backward()
        torch.cuda.synchronize()
        return [y.detach().float(), x.grad.float()] + [
            p.grad.float() for p in block.parameters()]

    zero_counts()
    got = run()
    counts = launch_counts()
    want = dict(fused_premlp_res=1, fused_slice_pool=1,
                fused_premlp_res_bwd=1, fused_slice_pool_bwd=1)
    if {k: v for k, v in counts.items() if v} != want:
        raise RuntimeError(f"TransolverBlock C={c}: launches {counts}, "
                           f"expected {want}")
    with plain_versions():
        ref = run()
    if launch_counts() != counts:
        raise RuntimeError(f"TransolverBlock C={c}: the plain versions' "
                           f"pass launched a kernel")
    rels, coss = [], []
    for name, a, b in zip(names, got, ref):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        if not bool(torch.isfinite(a).all()) or not bool(b.any()):
            raise RuntimeError(f"TransolverBlock C={c}[{name}]: not finite "
                               f"or a zero reference")
        rels.append(float((a - b).norm() / b.norm()))
        coss.append(float(a @ b / (a.norm() * b.norm())))
    worst, low = int(np.argmax(rels)), int(np.argmin(coss))
    log(f"TransolverBlock C={c} ({heads} heads, {slices} slices, bf16) x "
        f"[{batch},{nodes},{c}], forward and backward, kernels vs plain "
        f"versions: launches {want}; output relative norm {rels[0]:.3g}, "
        f"dx {rels[1]:.3g}; largest relative norm {rels[worst]:.3g} "
        f"({names[worst]}; tolerance 3e-2), lowest cosine {coss[low]:.6f} "
        f"({names[low]}; tolerance 0.999)")
    if max(rels) > 3e-2 or min(coss) < 0.999:
        raise RuntimeError(f"TransolverBlock C={c}: the kernels disagree "
                           f"with the plain versions")
    return dict(max_rel=max(rels), min_cos=min(coss))


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


def drive(name, cfg, sim, norm_state, dyn, static, steps, per_step, n_real,
          batch=BATCH):
    """`steps` rollout steps of `sim` with the counters set to 0 just before
    and read just after; then step 1 again with the plain versions on the
    card. `static` None: the segment engine (`rollout` on the stacked
    MeshSample `dyn`), else the block engine. Returns the counts of the
    rollout and its records."""
    from gen_fvgn_tpu_torch.solve import rollout as seg
    from gen_fvgn_tpu_torch.solve import rollout_block as blk
    if static is None:
        eval_step = lambda plain=False: seg.make_eval_step(
            cfg, sim, plain_kernels=plain)
        run = lambda **kw: seg.rollout(cfg, sim, norm_state, dyn, steps,
                                       **kw)
    else:
        eval_step = lambda plain=False: functools.partial(
            blk.make_eval_step_block(cfg, sim, plain_kernels=plain),
            static=static)
        run = lambda **kw: blk.rollout_block(cfg, sim, norm_state, dyn,
                                             static, steps, **kw)
    n_pad = dyn.uvp.shape[1]
    eval_step()(norm_state, dyn)                               # warm-up
    torch.cuda.synchronize()
    zero_counts()
    stamps = [time.perf_counter()]
    hist = run(
        export_fn=lambda t, un, uc, rec: stamps.append(time.perf_counter()))
    counts = launch_counts()
    step_ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:])]
    for rec, ms in zip(hist, step_ms):
        for key in ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press"):
            if rec[key].shape != (batch,) or not np.isfinite(rec[key]).all():
                raise RuntimeError(f"{name} step {rec['step']}: {key} not "
                                   f"finite")
        un, uc = rec["uvp_node"], rec["uvp_cell"]
        if un.shape != (batch, n_pad, 3) or not np.isfinite(un).all() \
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
    log(f"{name} rollout: {steps} steps, batch {batch}, median "
        f"{float(np.median(step_ms)):.2f} ms/step (host clock, state copied "
        f"to the host each step); launches {counts}")
    if counts != expected:
        raise RuntimeError(f"{name}: launch counts {counts} != expected "
                           f"{expected}")
    if np.abs(hist[-1]["uvp_node"] - hist[0]["uvp_node"]).max() == 0:
        raise RuntimeError(f"{name}: the rollout did not move the state")

    # step 1 again with the kernels' plain versions on the card
    plain = eval_step(plain=True)(norm_state, dyn)
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


def step1_grads(cfg, sim, norm_state, dyn, static, plain, accumulate=True):
    """d loss / d parameter of one training step's loss (forward with
    normalizer accumulation, or without it as in a solve, then
    `training_loss`), with the kernels or with their plain versions;
    `static` None: the segment engine's forward on the MeshSample `dyn`."""
    import contextlib

    from gen_fvgn_tpu_torch.ops import plain_versions
    from gen_fvgn_tpu_torch.training.forward import (forward_batch,
                                                     training_loss)
    from gen_fvgn_tpu_torch.training.forward_block import forward_batch_block
    params = list(sim.parameters())
    with (plain_versions() if plain else contextlib.nullcontext()), \
            torch.enable_grad():
        if static is None:
            out = forward_batch(sim, norm_state, dyn, cfg,
                                accumulate_normalizer=accumulate)
        else:
            out = forward_batch_block(sim, norm_state, dyn, static, cfg,
                                      accumulate_normalizer=accumulate)
        loss = training_loss(out, cfg)
        grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), grads


def hold_step1_grads(name, cfg, sim, norm_state, dyn, static,
                     accumulate=True):
    """Step 1's gradients with the kernels against those with the plain
    versions on the card, on the same batch; raises outside the limits.
    Returns (loss, gradients) with the kernels."""
    return hold_grads(name, sim, lambda plain: step1_grads(
        cfg, sim, norm_state, dyn, static, plain, accumulate))


def hold_grads(name, sim, grads_of):
    """The gradients of `sim`'s parameters that grads_of(plain) returns
    with (loss, gradients), with the kernels (plain=False) against those
    with their plain versions on the card; raises outside the limits.
    Returns (loss, gradients) with the kernels."""
    loss_k, g_k = grads_of(False)
    counts = launch_counts()
    loss_p, g_p = grads_of(True)
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


def check_segment_forms(n_pad, e_pad, flush_buf, gen, h=128):
    """K2 and K3 at the segment engine's two part forms, which the block
    engine never gives them: the edge MLP's one plain 3h-wide part (384)
    and the node MLP's one (h/2 + h)-wide part (192), which the wrapper
    zero-pads with its W1 rows to 256; no pre-projected input, no residual;
    rows batch-major, 8 lanes of 8 * padded faces or nodes. Each against
    its plain version (2 bf16 ulps of each output's scale; the backward
    twice for the same bits). The bound is that of the function on its
    real width. Returns {form: {"fused_mlp_ln": row, "fused_mlp_ln_bwd":
    row}}."""
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    bf = torch.bfloat16
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = {}
    for form, m, k, k_run in (("edge_mlp(part 3h)", BATCH * e_pad, 3 * h,
                               3 * h),
                              (f"node_mlp(part {h // 2 + h}, padded)",
                               BATCH * n_pad, h // 2 + h,
                               -(-(h // 2 + h) // 128) * 128)):
        w = mlp_weights(gen, k, h, h)
        part = torch.nn.functional.pad(g(m, k), (0, k_run - k)).to(bf)
        w1 = torch.nn.functional.pad(w["w1"], (0, 0, 0, k_run - k)).to(bf)
        fwd = ([part], [w1.contiguous()], w["b1"], w["w2"].to(bf), w["b2"],
               w["w3"].to(bf), w["b3"], w["gamma"], w["beta"], ())
        run, run_ref = (lambda: fm.fused_mlp_ln(*fwd),
                        lambda: fm.fused_mlp_ln_reference(*fwd))
        out, ref = run(), run_ref()
        torch.cuda.synchronize()
        err, _ = err_stats(out, ref)
        tol = ulps_of_scale(ref, 2)
        if err > tol or out.dtype != bf or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"fused_mlp_ln[{form}] disagrees with its "
                               f"plain version: max abs {err} > {tol}")
        moved = nbytes(out, fwd[2 + 1], fwd[5]) + m * k * 2 + k * h * 2 \
            + 4 * 5 * h
        fwd_row = with_bound(dict(max_abs_err=err, ms=median_ms(run, flush_buf),
                                  plain_ms=median_ms(run_ref, flush_buf,
                                                     iters=5, warmup=1)),
                             m, moved, 2.0 * m * (k * h + 2 * h * h))
        log(f"kernel fused_mlp_ln[{form}] H={h} M={m} bf16: max_abs_err="
            f"{err:.3g} (tolerance {tol:.3g} = 2 bf16 ulps of the output "
            f"scale) ms={fwd_row['ms']:.4f} plain_ms={fwd_row['plain_ms']:.4f}"
            f" bound_ms={fwd_row['bound_ms']:.4f} ({fwd_row['bound_by']})")
        dout = g(m, h).to(bf)
        bwd = (fwd[0], fwd[1], w["b1"], fwd[3], w["b2"], fwd[5], w["b3"],
               w["gamma"], (), [dout], None, False, BATCH)
        got, row = hold_backward(
            f"fused_mlp_ln_bwd[{form}] H={h}",
            lambda: fm.fused_mlp_ln_bwd(*bwd),
            lambda: fm.fused_mlp_ln_bwd_reference(*bwd), flush_buf)
        moved = nbytes(dout, fwd[3], fwd[5], got.dw2, got.dw3) \
            + 2 * (2 * m * k + 2 * k * h) + 4 * 8 * h
        # remat: x W1, h1 W2, h2 W3; backward: dW3, dh2, dW2, dh1, dW1, dx
        rows[form] = dict(fused_mlp_ln=fwd_row, fused_mlp_ln_bwd=with_bound(
            row, m, moved, 2.0 * m * (3 * k * h + 6 * h * h)))
        log(f"  fused_mlp_ln_bwd[{form}] H={h}: M={m} bound_ms="
            f"{rows[form]['fused_mlp_ln_bwd']['bound_ms']:.4f} "
            f"({rows[form]['fused_mlp_ln_bwd']['bound_by']})")
    return rows


# launches of one segment step at the Config defaults (TransFVGN_v2, 2
# processors of 3 GnBlocks): the encoders and 6 x (edge, node) MLPs, the
# decoder, a pre-LN MLP and a slice pool a Transolver block where the
# padded node count is a multiple of 256 (the JAX package's condition for
# the fused attention), and no sparse-apply kernel at all
SEG_FWD = dict(fused_mlp_ln=14, fused_mlp_noln=1, fused_premlp_res=2,
               fused_slice_pool=2)
SEG_TRAIN = dict(SEG_FWD, fused_mlp_ln_bwd=14, fused_mlp_noln_bwd=1,
                 fused_premlp_res_bwd=2, fused_slice_pool_bwd=2)


def drive_segment(card):
    """Phase "segment": the JAX package's default engine through the
    kernels, at the Config defaults, batch 8. On the 101 x 101-node cavity
    (padded to 10,240 nodes and 20,224 faces): a 3-step `rollout` (step 1
    against the plain versions), step 1's gradients against the plain
    versions, the run-to-run spread of the segment sums (an eval step and
    step 1's gradients twice with the kernels), 3 train steps of
    `make_train_step` from `init_train_state` (batches from
    `batch_indices`, `payback` after the last), one time step of
    `solve_adam` at batch 1 (20 inner steps); on the 100 x 100-node cavity
    (10,112 nodes and 19,840 faces: odd multiples of 128, so the slice
    attention takes its plain form, as in JAX) two rollout steps and one
    train step with step 1's gradients against the plain versions. Each
    path's counters are set to 0 just before it and read just after: K2-K7
    at SEG_FWD / SEG_TRAIN a step, K1, K8, K9 never. Returns the timings."""
    from gen_fvgn_tpu_torch import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_adam
    from gen_fvgn_tpu_torch.solve.rollout import make_eval_step
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train import (init_train_state,
                                                   make_train_step)
    name = "segment"
    t_phase = time.perf_counter()
    cfg = Config(batch_size=BATCH, dataset_size=BATCH)
    if cfg.engine != "segment":
        raise RuntimeError("the Config's default engine is not segment")
    t = {}
    out = {}
    for key, n in (("main", MESH_N), ("odd", MESH_N - 1)):
        t0 = time.perf_counter()
        pool = EnvPool([], cfg, seed=0, engine="segment", cases=[
            synthetic_case(cavity_quad_mesh(n), continuity=1, convection=1,
                           grad_p=1, mu=0.05, sigma=(1, 1, 1))])
        t[f"statics_s_{key}"] = time.perf_counter() - t0
        sz = pool.sizes
        log(f"{name} statics ({key}): {t[f'statics_s_{key}']:.2f} s; nodes "
            f"{pool.cases[0]['mesh']['node|pos'].shape[0]} (padded "
            f"{sz.n_nodes}), faces {sz.n_faces}, cells {sz.n_cells}, slots "
            f"{sz.n_slots}, stencil {sz.n_stencil} (padded); a multiple of "
            f"256: nodes {sz.n_nodes % 256 == 0}, faces "
            f"{sz.n_faces % 256 == 0}")
        out[key] = pool
    pool = out["main"]
    n_real = pool.cases[0]["mesh"]["node|pos"].shape[0]
    batch = pool.gather_batch(np.arange(BATCH))
    state, sim = init_train_state(cfg, seed=0)
    ns = state.norm_state

    # rollout, 3 steps, and step 1 against the plain versions
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, hist = drive(f"{name} {cfg.net}", cfg, sim, ns, batch, None, 3,
                         SEG_FWD, n_real)
    t["rollout_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    t["rollout_launches"] = counts

    # the run-to-run spread of the segment sums (atomics): the same eval
    # step and the same step-1 gradients twice with the kernels
    eval_step = make_eval_step(cfg, sim)
    a, b = eval_step(ns, batch), eval_step(ns, batch)
    spread_state = float((a.uvp_node_new - b.uvp_node_new).abs().max())
    spread_loss = float(((a.loss_cont - b.loss_cont).abs()
                         / b.loss_cont.abs()).max())
    loss_1, g_1 = step1_grads(cfg, sim, ns, batch, None, False)
    loss_2, g_2 = step1_grads(cfg, sim, ns, batch, None, False)
    diff = torch.sqrt(sum(((x.float() - y.float()) ** 2).sum()
                          for x, y in zip(g_1, g_2)))
    spread_grad = float(diff / torch.sqrt(sum((y.float() ** 2).sum()
                                              for y in g_2)))
    same_bits = all(torch.equal(x, y) for x, y in zip(g_1, g_2))
    del g_1, g_2
    t["spread"] = dict(uvp_node_max_abs=spread_state,
                       loss_cont_rel=spread_loss, grad_rel_norm=spread_grad,
                       loss_rel=abs(loss_1 - loss_2) / abs(loss_2),
                       grads_same_bits=same_bits)
    log(f"{name} run-to-run spread (the same step twice with the kernels; "
        f"segment sums add by atomics): uvp_node max {spread_state:.3g}, "
        f"loss_cont relative {spread_loss:.3g}; step 1 gradients relative "
        f"norm {spread_grad:.3g}, the same bits {same_bits}, loss relative "
        f"{t['spread']['loss_rel']:.3g} (limits: the kernel-vs-plain ones, "
        f"2e-2 on the state and the gradients)")
    if not spread_state <= 2e-2 or not spread_grad <= 2e-2:
        raise RuntimeError(f"{name}: the run-to-run spread exceeds the bf16 "
                           f"bounds")

    # step 1's gradients against the plain versions, then 3 train steps
    hold_step1_grads(f"{name} {cfg.net} train", cfg, sim, ns, batch, None)
    train_step = make_train_step(cfg, sim)
    start = [p.detach().clone() for p in sim.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_ms = []
    for k in range(3):
        idxs = pool.batch_indices(step_seed=k)[0]
        t0 = time.perf_counter()
        state, m, uvp_new = train_step(state, pool.gather_batch(idxs))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        loss, gnorm = float(m.loss), float(m.grad_norm)
        log(f"{name} train step {k + 1}: loss={loss:.6g} "
            f"loss_cont={float(m.loss_cont):.6g} "
            f"loss_mom={float(m.loss_mom):.6g} grad_norm={gnorm:.6g} "
            f"ms={step_ms[-1]:.2f}")
        if not np.isfinite(loss) or not np.isfinite(gnorm) or gnorm <= 0:
            raise RuntimeError(f"{name} train step {k + 1}: loss {loss}, "
                               f"grad_norm {gnorm}")
    pool.payback(idxs, uvp_new)
    torch.cuda.synchronize()
    counts = launch_counts()
    t["train_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    expected = {k: SEG_TRAIN.get(k, 0) * 3 for k in counts}
    log(f"{name} train: 3 steps, batch {BATCH}, ms {[round(x, 2) for x in step_ms]}"
        f" (host clock, gather and step, ending in a synchronize); peak "
        f"device memory {t['train_peak_mib']:.0f} MiB; launches {counts}")
    if counts != expected:
        raise RuntimeError(f"{name} train: launch counts {counts} != "
                           f"expected {expected}")
    moved = max(float((p.detach() - p0).abs().max())
                for p, p0 in zip(sim.parameters(), start))
    back = pool.gather_batch(idxs).uvp
    if not moved > 0 or not torch.equal(back, uvp_new) \
            or bool((uvp_new[:, n_real:] != 0).any()):
        raise RuntimeError(f"{name} train: parameters did not move, or the "
                           f"payback did not write the new states")
    t.update(train_step_ms=step_ms, train_launches=counts)

    # one time step of solve_adam at batch 1, from the trained weights
    one = pool.gather_batch(np.asarray([0]))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    _, h = solve_adam(cfg, sim, state.norm_state, one, n_time_steps=1)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    n_inner = cfg.max_inner_steps
    expected = {k: n_inner * SEG_TRAIN.get(k, 0) + SEG_FWD.get(k, 0)
                for k in counts}
    losses = h[0]["inner_losses"]
    log(f"{name} solve_adam: 1 time step of {n_inner} inner steps at batch "
        f"1: {solve_s:.2f} s ({1e3 * solve_s / n_inner:.2f} ms an inner "
        f"step, the final forward included); inner losses {losses[0]:.6g} "
        f"-> {losses[-1]:.6g}; launches {counts}")
    if counts != expected or not losses[-1] < losses[0] \
            or not np.isfinite(h[0]["uvp_node"]).all():
        raise RuntimeError(f"{name} solve_adam: launches {counts} (expected "
                           f"{expected}) or losses {losses}")
    t["solve_adam_ms_per_inner_step"] = 1e3 * solve_s / n_inner
    del sim, state, pool, batch

    # the odd multiples of 128: K6/K7 idle there, as in JAX
    pool = out.pop("odd")
    n_real = pool.cases[0]["mesh"]["node|pos"].shape[0]
    batch = pool.gather_batch(np.arange(BATCH))
    state, sim = init_train_state(cfg, seed=0)
    odd_fwd = dict(SEG_FWD, fused_slice_pool=0)
    drive(f"{name} {cfg.net} (10,112 nodes)", cfg, sim, state.norm_state,
          batch, None, 2, odd_fwd, n_real)
    hold_step1_grads(f"{name} {cfg.net} train (10,112 nodes)", cfg, sim,
                     state.norm_state, batch, None)
    zero_counts()
    state, m, _ = make_train_step(cfg, sim)(state, batch)
    counts = launch_counts()
    expected = dict({c: 0 for c in counts}, **SEG_TRAIN)
    expected.update(fused_slice_pool=0, fused_slice_pool_bwd=0)
    log(f"{name} train step (10,112 nodes): loss={float(m.loss):.6g} "
        f"grad_norm={float(m.grad_norm):.6g}; launches {counts}")
    if counts != expected or not np.isfinite(float(m.loss)):
        raise RuntimeError(f"{name} (10,112 nodes): launches {counts} != "
                           f"{expected}")
    t["phase_s"] = time.perf_counter() - t_phase
    log(f"{name}: phase {t['phase_s']:.1f} s; card: {card}")
    return t


class PoolSpy:
    """While active, records what `train()` does to its EnvPool: the pool
    itself, the slot each `reset_env` re-rolls (and in which epoch),
    and what each `inject_wave_sources` added to each case pool's states
    (kept on the card; read after the run)."""

    def __init__(self):
        from gen_fvgn_tpu_torch.training.pool import EnvPool
        self.cls, self.pools, self.rerolled, self.added = EnvPool, [], [], []

    def __enter__(self):
        cls, spy = self.cls, self
        self.saved = init, reset, inject = (
            cls.__init__, cls.reset_env, cls.inject_wave_sources)

        def _init(pool, *a, **k):
            init(pool, *a, **k)
            spy.pools.append(pool)

        def _reset(pool, *a, **k):
            spy.rerolled.append((len(spy.added), pool._age_order[0]))
            reset(pool, *a, **k)

        def _inject(pool):
            before = {ci: p.uvp.clone() for ci, p in pool._dyn_pools.items()}
            inject(pool)
            spy.added.append({ci: p.uvp - before[ci]
                              for ci, p in pool._dyn_pools.items()})
        cls.__init__, cls.reset_env = _init, _reset
        cls.inject_wave_sources = _inject
        return self

    def __exit__(self, *exc):
        (self.cls.__init__, self.cls.reset_env,
         self.cls.inject_wave_sources) = self.saved


def timed_ms(fn, reps=5):
    """Median host-clock ms of fn(), each call between two synchronizes."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def drive_training_run(cfg, per_step, bare_ms):
    """Phase "training run": `train()` (training/loop.py) at the main path's
    widths on two cases of the 101x101-node cavity, the main path's
    Navier-Stokes case and a wave case: 16 environments (8 a case, one
    batch of 8 a case an inner step), 20 inner steps, 3 epochs (120 train
    steps), a re-roll after every epoch from epoch 1 with export on reset,
    wave sources after every epoch, checkpoints at epochs 0 and 2. Checks
    the counts, the log, the re-rolls, the injections, the checkpoints and
    the launches (120 x the main path's per-step counts); then restores
    2.state into a fresh state (bit-equal) and takes one more step from
    each on the same batch (the same bits). Returns (state, pool, timings)."""
    import glob
    import os
    import tempfile

    from gen_fvgn_tpu_torch.io.checkpoint import load_state, save_state
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case, wave_case)
    from gen_fvgn_tpu_torch.training import loop
    from gen_fvgn_tpu_torch.training.train import step_exp_lr
    from gen_fvgn_tpu_torch.training.train_block import (
        init_train_state_block, make_train_step_block)
    t_phase = time.perf_counter()
    name = "training run"
    rcfg = cfg.replace(engine="block", n_epochs=3, dataset_size=16,
                       average_sequence_length=16, export_on_reset=True,
                       max_inner_steps=20)
    mesh = cavity_quad_mesh(MESH_N)
    cases = [synthetic_case(mesh, continuity=1, convection=1, grad_p=1,
                            mu=0.05, sigma=(1, 1, 1)),
             wave_case(mesh, dt=0.05, source_strength=(0.02,) * 3)]
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 20
    zero_counts()
    t0 = time.perf_counter()
    with PoolSpy() as spy:
        state = loop.train(rcfg, cases=cases, log_base_dir=tmp.name, seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pool, = spy.pools
    steps = rcfg.n_epochs * rcfg.max_inner_steps * 2
    expected = {k: per_step.get(k, 0) * steps for k in counts}
    run_dir, = glob.glob(os.path.join(tmp.name, "*", "*"))
    lines = open(os.path.join(run_dir, "Loss_monitor.dat")).read() \
        .splitlines()
    cols = lines[0].split("=")[1].replace('"', "").split(",")
    rows = [dict(zip(cols, map(float, ln.split(",")))) for ln in lines[1:]]
    schedule = step_exp_lr(rcfg)
    exports = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(run_dir, "traing_results", "*.dat")))
    slots = sorted(os.listdir(os.path.join(run_dir, "states")))
    for r in rows:
        log(f"{name} epoch {int(r['step'])}: loss={r['loss']:.6g} "
            f"loss_cont={r['loss_cont']:.6g} loss_mom={r['loss_mom']:.6g} "
            f"grad_norm={r['grad_norm']:.6g} lr={r['lr']:.6g} "
            f"epoch_seconds={r['epoch_seconds']:.4f}")
    wave = {i for i, e in enumerate(pool.envs)
            if e.theta_sample.source_frequency != 0}
    moved = []
    for added in spy.added:
        for ci, d in added.items():
            rows_w = [pool._env_local[i] for i in wave
                      if pool.envs[i].case_idx == ci]
            rows_n = [pool._env_local[i] for i in range(len(pool.envs))
                      if i not in wave and pool.envs[i].case_idx == ci]
            if float(d[..., :2].abs().max()) != 0 or (
                    rows_n and float(d[rows_n].abs().max()) != 0):
                raise RuntimeError(f"{name}: the injection touched u, v or "
                                   f"an NS environment")
            if rows_w:
                moved.append(float(d[rows_w, :, 2].abs().amax(1).min()))
    log(f"{name}: {state.step} train steps, epoch {state.epoch}, "
        f"{run_s:.2f} s (host clock, statics of the two cases included); "
        f"peak device memory {peak:.0f} MiB ({base:.0f} held before it); "
        f"re-rolled (epoch, slot) "
        f"{spy.rerolled}; exports {exports}; checkpoint slots {slots}; "
        f"injections {len(spy.added)}, each wave environment's p moved by "
        f"at least {min(moved) if moved else 0:.3g}; launches {counts}")
    lr_ok = all(float(f"{schedule(int(r['step'])):.9e}") == r["lr"]
                for r in rows)
    if state.step != steps or state.epoch != 3 or len(rows) != 3 \
            or not all(np.isfinite([r["loss"], r["loss_cont"], r["loss_mom"],
                                    r["grad_norm"]]).all() for r in rows) \
            or not lr_ok or [e for e, _ in spy.rerolled] != [1, 2] \
            or len(exports) != 2 or slots != ["0.state", "2.state"] \
            or len(spy.added) != 3 or len(moved) != 3 or min(moved) <= 0:
        raise RuntimeError(f"{name}: a check failed (steps {state.step}, "
                           f"epoch {state.epoch}, rows {len(rows)}, lr as "
                           f"the schedule {lr_ok}, re-rolls {spy.rerolled}, "
                           f"exports {exports}, slots {slots})")
    if counts != expected:
        raise RuntimeError(f"{name}: launch counts {counts} != expected "
                           f"{expected}")

    # resume: 2.state into a fresh state, then one step from each
    fresh, fsim = init_train_state_block(rcfg.replace(dataset_size=16),
                                         seed=1)
    load_state(os.path.join(run_dir, "states", "2.state"), like=fresh)
    pairs = [(a, b) for a, b in zip(state.simulator.parameters(),
                                    fsim.parameters())]
    ost, fst = state.optimizer.state_dict()["state"], \
        fresh.optimizer.state_dict()["state"]
    same = all(torch.equal(a, b) for a, b in pairs) and all(
        torch.equal(ost[i][k], fst[i][k]) for i in ost
        for k in ("exp_avg", "exp_avg_sq", "step")) and all(
        torch.equal(getattr(state.norm_state, f), getattr(fresh.norm_state, f))
        for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_acc")) \
        and (fresh.step, fresh.epoch) == (state.step, state.epoch)
    ci, idxs = pool.block_batches(step_seed=10 ** 6)[0]
    dyn = pool.gather_block(idxs)
    going = copy.deepcopy(state)          # the run's state, one step on
    _, ma, ua = make_train_step_block(rcfg, going.simulator)(
        going, dyn, pool.statics[ci])
    _, mb, ub = make_train_step_block(rcfg, fsim)(fresh, dyn,
                                                  pool.statics[ci])
    step_same = torch.equal(ma.loss, mb.loss) and torch.equal(ua, ub) and all(
        torch.equal(a, b) for a, b in zip(going.simulator.parameters(),
                                          fsim.parameters()))
    del going, fresh, fsim
    log(f"{name} resume: 2.state restored into a fresh state, parameters, "
        f"Adam moments, normalizer and counters bit-equal: {same}; one more "
        f"step from each on the same batch, loss {float(ma.loss):.7g} / "
        f"{float(mb.loss):.7g}, the same bits: {step_same}")
    if not same or not step_same:
        raise RuntimeError(f"{name}: the restored state or its next step "
                           f"differs")

    # the per-epoch work outside the steps, each between two synchronizes
    ci, idxs = pool.block_batches(step_seed=1)[0]
    uvp = pool.gather_block(idxs).uvp
    logger = type("L", (), {"log_scalars": lambda *a: None})()
    t = dict(
        payback_ms=timed_ms(lambda: pool.payback_block(idxs, uvp)),
        reroll_ms=timed_ms(lambda: pool.reset_env_block()),
        reroll_export_ms=timed_ms(
            lambda: pool.reset_env_block(export_dir=tmp.name)),
        inject_ms=timed_ms(pool.inject_wave_sources),
        log_ms=timed_ms(lambda: loop._log_epoch(logger, 0, ma, 0.0)))
    path = os.path.join(tmp.name, "timed.state")
    t["checkpoint_ms"] = timed_ms(lambda: save_state(state, path))
    t["checkpoint_bytes"] = os.path.getsize(path)
    inner = [r["epoch_seconds"] for r in rows]
    overhead = t["payback_ms"] * 2 + t["reroll_ms"] + t["inject_ms"] \
        + t["log_ms"]
    with_export = overhead - t["reroll_ms"] + t["reroll_export_ms"]
    t["epoch_seconds"] = inner
    t["inner_step_ms"] = [1e3 * s / steps * rcfg.n_epochs for s in inner]
    # epochs 1 and 2 (epoch 0 has the first calls' set-up), their per-epoch
    # work (with the export on reset) taken out
    t["inner_step_ms_without_overhead"] = [
        (1e3 * s - with_export) / steps * rcfg.n_epochs for s in inner[1:]]
    t["overhead_ms"] = overhead
    t["peak_mib"], t["held_before_mib"] = peak, base
    t["phase_s"] = time.perf_counter() - t_phase
    log(f"{name} timings (host clock): epoch seconds {inner} (each ends in "
        f"the log's one transfer), so ms per inner step "
        f"{[round(x, 3) for x in t['inner_step_ms']]}, without the "
        f"per-epoch work (epochs 1, 2) "
        f"{[round(x, 3) for x in t['inner_step_ms_without_overhead']]}, "
        f"against the bare step's median {bare_ms:.2f}; per-epoch work: "
        f"payback "
        f"{t['payback_ms']:.3f} ms (x2 cases), re-roll {t['reroll_ms']:.3f} "
        f"ms ({t['reroll_export_ms']:.3f} with the export), injection "
        f"{t['inject_ms']:.3f} ms, log {t['log_ms']:.3f} ms: {overhead:.3f} "
        f"ms an epoch without export and checkpoint; checkpoint save "
        f"{t['checkpoint_ms']:.3f} ms, {t['checkpoint_bytes']} bytes; phase "
        f"{t['phase_s']:.1f} s")
    tmp.cleanup()
    return state, pool, t


def drive_solves(state, pool, per_step, fwd_per_step):
    """Phase "solves", from the training run's final state on its
    Navier-Stokes case: `solve_adam_block` at batch 1 (2 time steps x 20
    inner steps; step 1's gradients held against the plain versions on the
    card; launches 40 x a train step's plus the two final forwards); the
    chunked form at batch 12, microbatch 8 (two chunks, four pad rows; 1 x
    3) held against the same solve unchunked; `solve_lbfgs_block` at batch
    1, memory 100, 1 time step x 5 iterations, its function evaluations per
    iteration logged. Each loss must fall. Returns the timings."""
    from gen_fvgn_tpu_torch.solve import lbfgs
    from gen_fvgn_tpu_torch.solve.instance_opt import (solve_adam_block,
                                                       solve_lbfgs_block)
    t_phase = time.perf_counter()
    cfg = pool.cfg
    ns = [i for i, e in enumerate(pool.envs)
          if e.theta_sample.source_frequency == 0]
    ci = pool.envs[ns[0]].case_idx
    static, norm, sim = pool.statics[ci], state.norm_state, state.simulator
    dyn1 = pool.gather_block(np.asarray(ns[:1]))
    t, held = {}, []          # device memory held as each solve starts

    def run(name, fn, dyn, n_inner, n_chunks, **kw):
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held.append(torch.cuda.memory_allocated() / 2 ** 20)
        zero_counts()
        over = kw.pop("cfg", {})
        stamps.append(time.perf_counter())
        _, hist = fn(cfg.replace(**over), sim, norm, dyn, static,
                     export_fn=lambda *a: stamps.append(time.perf_counter()),
                     **kw)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        ms = [1e3 * (b - a) / n_inner for a, b in zip(stamps, stamps[1:])]
        for rec in hist:
            v = rec["inner_losses"]
            log(f"solve {name} time step {rec['step']}: inner losses "
                f"{v[0]:.7g} -> {v[-1]:.7g} ({len(v)}); max|uvp| "
                f"{np.abs(rec['uvp_node']).max():.4g}")
            if not np.isfinite(v).all() or not v[-1] < v[0] \
                    or not np.isfinite(rec["uvp_node"]).all():
                raise RuntimeError(f"solve {name}: the loss did not fall or "
                                   f"is not finite")
        return hist, counts, ms, peak

    # Adam at batch 1; first its step-1 gradients against the plain versions
    hold_step1_grads("solve adam batch 1", cfg, sim, norm, dyn1, static,
                     accumulate=False)
    hist, counts, ms, peak = run("adam batch 1", solve_adam_block, dyn1, 20,
                                 1, n_time_steps=2, inner_steps=20)
    expected = {k: 40 * per_step.get(k, 0) + 2 * fwd_per_step.get(k, 0)
                for k in counts}
    log(f"solve adam batch 1: {ms[0]:.2f} / {ms[1]:.2f} ms an inner step "
        f"(host clock, time steps 1 / 2, the final forward and host copies "
        f"included); peak device memory {peak:.0f} MiB; launches {counts}")
    if counts != expected:
        raise RuntimeError(f"solve adam batch 1: launch counts {counts} != "
                           f"expected {expected}")
    t.update(adam_b1_ms=ms, adam_b1_peak_mib=peak,
             launches_per_inner_step={k: (v - 2 * fwd_per_step.get(k, 0))
                                      // 40 for k, v in counts.items()})

    # batch 12 in chunks of 8 (four pad rows) against the unchunked solve
    dyn12 = pool.gather_block(np.asarray([ns[i % len(ns)]
                                          for i in range(12)]))
    hc, counts, ms_c, peak_c = run("adam batch 12 chunked", solve_adam_block,
                                   dyn12, 3, 2, n_time_steps=1,
                                   inner_steps=3, cfg=dict(microbatch=8))
    expected = {k: 6 * per_step.get(k, 0) + 2 * fwd_per_step.get(k, 0)
                for k in counts}
    hu, _, ms_u, peak_u = run("adam batch 12 unchunked", solve_adam_block,
                              dyn12, 3, 1, n_time_steps=1, inner_steps=3,
                              cfg=dict(microbatch=0))
    loss_gap = float(np.abs(hc[0]["inner_losses"] - hu[0]["inner_losses"]).max()
                     / np.abs(hu[0]["inner_losses"]).max())
    uvp_gap = float(np.abs(hc[0]["uvp_node"] - hu[0]["uvp_node"]).max())
    # set from this check's first reading on an H100 (losses 4.7e-6
    # relative, states 6.7e-4 after 3 Adam steps of the bf16 net): about
    # 10x the losses' gap, and two flipped bf16 roundings of a state of
    # scale 1 (2^-8 each) plus the measured gap
    loss_tol, uvp_tol = 5e-5, 1e-2
    log(f"solve adam batch 12 chunked (microbatch 8) vs unchunked: inner "
        f"losses relative gap {loss_gap:.3g} (tolerance {loss_tol}), "
        f"uvp_node max gap {uvp_gap:.3g} (tolerance {uvp_tol}); "
        f"{ms_c[0]:.2f} / {ms_u[0]:.2f} ms an inner step; peak device "
        f"memory {peak_c:.0f} / {peak_u:.0f} MiB; chunked launches {counts}")
    if counts != expected or not loss_gap <= loss_tol \
            or not uvp_gap <= uvp_tol:
        raise RuntimeError(f"solve adam batch 12: chunked launches {counts} "
                           f"(expected {expected}) or chunked vs unchunked "
                           f"outside the tolerance")
    t.update(adam_b12_chunked_ms=ms_c[0], adam_b12_unchunked_ms=ms_u[0],
             adam_b12_chunked_peak_mib=peak_c,
             adam_b12_unchunked_peak_mib=peak_u,
             chunked_loss_gap=loss_gap, chunked_uvp_gap=uvp_gap)

    # L-BFGS at batch 1, memory 100
    evals = []
    step = lbfgs.LBFGS.step

    def counted(opt, f):
        v = step(opt, f)
        evals.append(opt.evaluations)
        return v
    lbfgs.LBFGS.step = counted
    try:
        hist, counts, ms, peak = run("lbfgs batch 1", solve_lbfgs_block, dyn1,
                                     5, 1, n_time_steps=1, max_iter=5,
                                     memory_size=100)
    finally:
        lbfgs.LBFGS.step = step
    expected = {k: sum(evals) * per_step.get(k, 0) + fwd_per_step.get(k, 0)
                for k in counts}
    log(f"solve lbfgs batch 1 (memory 100): {ms[0]:.2f} ms an iteration; "
        f"function evaluations per iteration {evals}; peak device memory "
        f"{peak:.0f} MiB; launches {counts}")
    if counts != expected:
        raise RuntimeError(f"solve lbfgs: launch counts {counts} != "
                           f"{expected}")
    t.update(lbfgs_ms=ms[0], lbfgs_evaluations=evals, lbfgs_peak_mib=peak,
             held_before_mib=held, phase_s=time.perf_counter() - t_phase)
    log(f"solves: phase {t['phase_s']:.1f} s; device memory held as each "
        f"solve started {[round(h) for h in held]} MiB")
    return t



class CliSpy:
    """While active, records what the CLIs do: the EnvPools they make, the
    train steps and mixed-step groups and batches they run, the seconds of
    each `load_case`, and a host-clock stamp at the start of each solve and
    after each time step's export."""

    def __init__(self):
        from gen_fvgn_tpu_torch.io import tecplot
        from gen_fvgn_tpu_torch.solve import (instance_opt, lbfgs, rollout,
                                              rollout_block)
        from gen_fvgn_tpu_torch.training import loop, pool
        from gen_fvgn_tpu_torch.training.train_block import \
            MixedTrainStepBlock
        self.mods = dict(tecplot=tecplot, loop=loop, pool=pool,
                         mixed=MixedTrainStepBlock, lbfgs=lbfgs.LBFGS,
                         instance_opt=instance_opt, rollout=rollout_block,
                         rollout_seg=rollout)
        self.reset()

    def reset(self):
        self.pools, self.steps, self.groups, self.batches = [], 0, 0, 0
        self.stamps, self.evaluations = [], []

    def __enter__(self):
        m, spy = self.mods, self
        self.saved = [
            (m["pool"].EnvPool, "__init__"), (m["loop"], "make_train_step_block"),
            (m["mixed"], "group_grads"), (m["mixed"], "run_batch"),
            (m["tecplot"], "write_tecplot_zone"), (m["lbfgs"], "step"),
            (m["rollout"], "rollout_block"), (m["rollout_seg"], "rollout"),
            (m["instance_opt"], "solve_adam_block"),
            (m["instance_opt"], "solve_lbfgs_block"),
            (m["instance_opt"], "solve_adam"),
            (m["instance_opt"], "solve_lbfgs")]
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name in self.saved]
        orig = {name: fn for _, name, fn in self.saved}

        def init(pool, *a, **k):
            orig["__init__"](pool, *a, **k)
            spy.pools.append(pool)

        def make_step(*a, **k):
            step = orig["make_train_step_block"](*a, **k)

            def counted(*sa, **sk):
                spy.steps += 1
                return step(*sa, **sk)
            return counted

        def group_grads(mixed, *a, **k):
            spy.groups += 1
            return orig["group_grads"](mixed, *a, **k)

        def run_batch(mixed, *a, **k):
            spy.batches += 1
            return orig["run_batch"](mixed, *a, **k)

        def write(*a, **k):
            orig["write_tecplot_zone"](*a, **k)
            spy.stamps.append(time.perf_counter())

        def lbfgs_step(opt, f):
            v = orig["step"](opt, f)
            spy.evaluations.append(opt.evaluations)
            return v

        def timed(fn):
            def run(*a, **k):
                spy.stamps.append(time.perf_counter())
                return fn(*a, **k)
            return run
        m["pool"].EnvPool.__init__ = init
        m["loop"].make_train_step_block = make_step
        m["mixed"].group_grads, m["mixed"].run_batch = group_grads, run_batch
        m["tecplot"].write_tecplot_zone = write
        m["lbfgs"].step = lbfgs_step
        m["rollout"].rollout_block = timed(orig["rollout_block"])
        m["rollout_seg"].rollout = timed(orig["rollout"])
        for f in ("solve_adam_block", "solve_lbfgs_block", "solve_adam",
                  "solve_lbfgs"):
            setattr(m["instance_opt"], f, timed(orig[f]))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def mixed_step_grads(cfg, sim, pool, batch, plain):
    """(weighted loss, summed gradients) of one `MixedTrainStepBlock` step
    on `batch` from a fresh normalizer, with the kernels or with their
    plain versions."""
    import contextlib

    from gen_fvgn_tpu_torch.ops import plain_versions
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    from gen_fvgn_tpu_torch.training.train_block import MixedTrainStepBlock
    from gen_fvgn_tpu_torch.utils.device import to_device
    mixed = MixedTrainStepBlock(cfg, sim)
    weights = [to_device(w, torch.device("cuda")) for _, _, w, _ in batch]
    with plain_versions() if plain else contextlib.nullcontext():
        sums = mixed.init_sums()
        for (ci, idxs, _, _), w in zip(batch, weights):
            sums = mixed.group_stats(sums, pool.gather_block(idxs),
                                     pool.statics[ci], w)
        norm = mixed.norm_update(init_normalizer(
            cfg.node_input_size - cfg.node_phi_size), sums)
        acc = mixed.init_acc()
        for (ci, idxs, _, _), w in zip(batch, weights):
            acc, _ = mixed.group_grads(norm, acc, pool.gather_block(idxs),
                                       pool.statics[ci], w)
    return float(acc["loss"]), acc["gsum"]


def drive_cli(card, per_step, fwd_per_step):
    """Phase "CLI": the user's entry points on case directories on disk.
    Writes two COMSOL cases of 10,201 nodes with `tools/case_files.py` (the
    main path's lid-driven quad cavity, and a triangle cavity of 20,000
    cells with an inflow, an outflow and other coefficients), times
    `load_case` on each, then runs `scripts.pre_train.main` at the Config
    defaults (TransFVGN_v2, hidden 128, bf16, batch 8, 16 environments)
    for 2 epochs of 2 inner steps with per-case batches and again with
    mixed-case batches, each checked for finite losses, its loss monitor,
    its checkpoint slots and its launches (the train steps, or the mixed
    steps' groups, x the main path's per-step counts); holds the summed
    gradients of a mixed step of two groups against the plain versions;
    and runs `scripts.solve.main --engine block` from the mixed run's
    checkpoint in the three modes, 2 time steps of 2 inner steps, each
    checked for its exports and launches. Returns the timings."""
    import glob
    import os
    import tempfile

    from gen_fvgn_tpu_torch.meshes.synthetic import synthetic_bc
    from gen_fvgn_tpu_torch.scripts import pre_train, solve
    from gen_fvgn_tpu_torch.tools.case_files import write_cavity_case
    from gen_fvgn_tpu_torch.training.pool import load_case
    from gen_fvgn_tpu_torch.training.train_block import init_train_state_block
    t_phase = time.perf_counter()
    name = "CLI"
    tmp = tempfile.TemporaryDirectory()
    data = os.path.join(tmp.name, "data")
    channel = synthetic_bc(continuity=1, convection=1, grad_p=1, mu=0.02,
                           sigma=(1, 1, 1))
    channel["theta_PDE"]["inlet"] = [0.5, 0.5, 1.0]
    dirs = [write_cavity_case(os.path.join(data, "cavity_quad"), n=MESH_N),
            write_cavity_case(os.path.join(data, "channel_tri"), n=MESH_N,
                              kind="tri", boundary="channel", bc=channel)]
    t = {"load_case_s": {}}
    for d in dirs:
        t0 = time.perf_counter()
        case = load_case(d)
        t["load_case_s"][os.path.basename(d)] = time.perf_counter() - t0
        mesh = case["mesh"]
        log(f"{name} load_case {os.path.basename(d)}: "
            f"{t['load_case_s'][os.path.basename(d)]:.3f} s; nodes "
            f"{mesh['node|pos'].shape[0]}, cells "
            f"{mesh['cell|centroid'].shape[0]}, faces "
            f"{mesh['face|face_node'].shape[1]}")
    torch.cuda.synchronize()
    t["held_before_mib"] = torch.cuda.memory_allocated() / 2 ** 20
    t["peak_mib"] = {}

    def start_peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def read_peak(key):
        torch.cuda.synchronize()
        t["peak_mib"][key] = torch.cuda.max_memory_allocated() / 2 ** 20

    spy = CliSpy()
    runs = {}
    with spy:
        for mode, mixed in (("stratified", "0"), ("mixed", "1")):
            spy.reset()
            pool = None               # the last run's statics go
            log_dir = os.path.join(tmp.name, f"runs_{mode}")
            start_peak()
            zero_counts()
            t0 = time.perf_counter()
            pre_train.main(["--dataset-dir", data, "--log-dir", log_dir,
                            "--epochs", "2", "--max-inner-steps", "2",
                            "--dataset-size", "16",
                            "--mixed-case-batches", mixed])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = launch_counts()
            read_peak(f"pre_train {mode}")
            run_dir, = glob.glob(os.path.join(log_dir, "*", "*"))
            lines = open(os.path.join(run_dir, "Loss_monitor.dat")) \
                .read().splitlines()
            cols = lines[0].split("=")[1].replace('"', "").split(",")
            rows = [dict(zip(cols, map(float, ln.split(","))))
                    for ln in lines[1:]]
            slots = sorted(os.listdir(os.path.join(run_dir, "states")))
            n = spy.groups if mixed == "1" else spy.steps
            expected = {k: per_step.get(k, 0) * n for k in counts}
            inner_ms = 1e3 * rows[-1]["epoch_seconds"] / 2
            runs[mode] = dict(seconds=run_s, inner_step_ms=inner_ms,
                              steps=spy.steps, batches=spy.batches,
                              groups=spy.groups, launches=counts,
                              losses=[r["loss"] for r in rows],
                              run_dir=run_dir)
            pool = spy.pools[-1]      # the mixed run's is kept, below
            for r in rows:
                log(f"{name} pre_train {mode} epoch {int(r['step'])}: "
                    f"loss={r['loss']:.6g} loss_cont={r['loss_cont']:.6g} "
                    f"loss_mom={r['loss_mom']:.6g} "
                    f"grad_norm={r['grad_norm']:.6g} "
                    f"epoch_seconds={r['epoch_seconds']:.4f}")
            log(f"{name} pre_train {mode}: {run_s:.2f} s (host clock, "
                f"reading both cases and their statics included); "
                f"{inner_ms:.2f} ms an inner step (epoch 1); train steps "
                f"{spy.steps}, mixed batches {spy.batches}, groups "
                f"{spy.groups}; checkpoint slots {slots}; peak device "
                f"memory {t['peak_mib'][f'pre_train {mode}']:.0f} MiB; "
                f"launches {counts}")
            if len(rows) != 2 or not all(np.isfinite(
                    [r["loss"], r["loss_cont"], r["loss_mom"],
                     r["grad_norm"]]).all() for r in rows) \
                    or slots != ["0.state", "1.state"] or n == 0 \
                    or (mixed == "0" and spy.batches) \
                    or (mixed == "1" and spy.steps):
                raise RuntimeError(f"{name} pre_train {mode}: a check failed "
                                   f"(rows {len(rows)}, slots {slots}, steps "
                                   f"{spy.steps}, groups {spy.groups})")
            if counts != expected:
                raise RuntimeError(f"{name} pre_train {mode}: launch counts "
                                   f"{counts} != expected {expected}")
        mix = runs["mixed"]
        t.update(inner_step_ms={m: r["inner_step_ms"]
                                for m, r in runs.items()},
                 train_s={m: r["seconds"] for m, r in runs.items()},
                 groups_per_mixed_batch=mix["groups"] / mix["batches"],
                 launches={m: r["launches"] for m, r in runs.items()})

        # the summed gradients of one mixed step of two groups, kernels
        # against plain versions, from the runs' initial weights
        batch = next(b for s in range(1, 50)
                     for b in pool.mixed_block_batches(step_seed=s)
                     if len(b) == 2)
        _, sim = init_train_state_block(pool.cfg, seed=0)
        log(f"{name} mixed step: groups (case, rows, real rows) "
            f"{[(ci, len(ix), g) for ci, ix, _, g in batch]}")
        hold_grads(f"{name} mixed", sim,
                   lambda plain: mixed_step_grads(pool.cfg, sim, pool, batch,
                                                  plain))
        del sim, pool

        # serving: solve from the mixed run's last checkpoint
        state = os.path.join(mix["run_dir"], "states", "1.state")
        t["checkpoint_bytes"] = os.path.getsize(state)
        t["solve_ms_per_time_step"] = {}
        for mode in ("rollout", "adam", "lbfgs"):
            spy.reset()
            out = os.path.join(tmp.name, f"solve_{mode}")
            start_peak()
            zero_counts()
            solve.main(["--case", dirs[0], "--engine", "block",
                        "--checkpoint", state, "--mode", mode, "--steps", "2",
                        "--inner-steps", "2", "--out-dir", out])
            counts = launch_counts()
            read_peak(f"solve {mode}")
            files = sorted(os.listdir(out))
            ms = [1e3 * (b - a) for a, b in zip(spy.stamps, spy.stamps[1:])]
            t["solve_ms_per_time_step"][mode] = ms
            n_train = {"rollout": 0, "adam": 4,
                       "lbfgs": sum(spy.evaluations)}[mode]
            expected = {k: n_train * per_step.get(k, 0)
                        + 2 * fwd_per_step.get(k, 0) for k in counts}
            log(f"{name} solve {mode}: {[round(x, 2) for x in ms]} ms a time "
                f"step (host clock, the export of the time step's Tecplot "
                f"file included; adam and lbfgs: 2 inner steps); exports "
                f"{files}; L-BFGS evaluations {spy.evaluations}; launches "
                f"{counts}")
            if files != ["step_00000.dat", "step_00001.dat"] \
                    or counts != expected:
                raise RuntimeError(f"{name} solve {mode}: exports {files}, "
                                   f"launches {counts} (expected {expected})")

        # solve at its default engine (segment, no --engine flag) on both
        # cases, from the same (block-trained) checkpoint
        t["segment_solve_ms_per_time_step"] = {}
        for d in dirs:
            case = os.path.basename(d)
            for mode in ("rollout", "adam", "lbfgs"):
                spy.reset()
                out = os.path.join(tmp.name, f"seg_{case}_{mode}")
                start_peak()
                zero_counts()
                solve.main(["--case", d, "--checkpoint", state, "--mode",
                            mode, "--steps", "2", "--inner-steps", "2",
                            "--out-dir", out])
                counts = launch_counts()
                read_peak(f"segment solve {case} {mode}")
                files = sorted(os.listdir(out))
                ms = [1e3 * (b - a)
                      for a, b in zip(spy.stamps, spy.stamps[1:])]
                t["segment_solve_ms_per_time_step"][f"{case} {mode}"] = ms
                n_train = {"rollout": 0, "adam": 4,
                           "lbfgs": sum(spy.evaluations)}[mode]
                expected = {k: n_train * SEG_TRAIN.get(k, 0)
                            + 2 * SEG_FWD.get(k, 0) for k in counts}
                log(f"{name} solve (default engine: segment) {case} {mode}: "
                    f"{[round(x, 2) for x in ms]} ms a time step (host "
                    f"clock, the export included); exports {files}; L-BFGS "
                    f"evaluations {spy.evaluations}; launches {counts}")
                if files != ["step_00000.dat", "step_00001.dat"] \
                        or counts != expected:
                    raise RuntimeError(
                        f"{name} segment solve {case} {mode}: exports "
                        f"{files}, launches {counts} (expected {expected})")
    t["phase_s"] = time.perf_counter() - t_phase
    log(f"{name}: load_case {t['load_case_s']} s; ms an inner step "
        f"{t['inner_step_ms']}; groups per mixed batch "
        f"{t['groups_per_mixed_batch']}; solve ms a time step "
        f"{t['solve_ms_per_time_step']}; at the default engine (segment) "
        f"{t['segment_solve_ms_per_time_step']}; checkpoint "
        f"{t['checkpoint_bytes']} "
        f"bytes; peak device memory {t['peak_mib']} MiB "
        f"({t['held_before_mib']:.0f} held before the phase); phase "
        f"{t['phase_s']:.1f} s; card: {card}")
    tmp.cleanup()
    return t


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
    # the redesigned kernels' registers and spills (-Xptxas -v)
    regs = dict(
        fused_premlp_res=register_summary(_cuda_build.BUILD_LOG,
                                          "premlp_rows"),
        pair_sum=register_summary(
            _cuda_build.BUILD_LOG, "pair_sum_kernel",
            main=("I13__nv_bfloat16S1_Li8ELi4E", "I13__nv_bfloat16S1_Li8ELi2E")),
        pair_transpose=register_summary(
            _cuda_build.BUILD_LOG, "pair_transpose_kernel",
            main=("I13__nv_bfloat16S1_Li8ELi2E",)))
    for name, r in regs.items():
        log(f"registers {name}: {json.dumps(r)}")

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
    # K2/K3 at the segment engine's part forms (their own generator; the
    # segment pool pads the same cavity to the same 10,240 / 20,224 rows)
    seg_forms = check_segment_forms(
        n_pad, e_pad, flush_buf,
        torch.Generator(device="cuda").manual_seed(14))
    del flush_buf
    # the net that raised above C = 1024: a Transolver block at hidden 1152
    check_wide_block()

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
    counts, bare_ms, _ = drive_training(cfg, pool, static, TRAIN_STEPS,
                                        per_step, n_real)

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

    # ---- phase 8b: the segment engine, the JAX package's default ----
    seg_t = drive_segment(card)
    log(json.dumps({"segment": seg_t}))

    # ---- phase 9: the training run around the step: train() over 3
    # epochs with re-rolls, wave sources, checkpoints, then a resume ----
    run_state, run_pool, run_t = drive_training_run(
        cfg, per_step, float(np.median(bare_ms)))

    # ---- phase 10: the solves from the run's final state ----
    solve_t = drive_solves(run_state, run_pool, per_step, tv)
    del run_state, run_pool

    # ---- phase 11: the CLIs on case directories on disk ----
    cli_t = drive_cli(card, per_step, tv)
    log(json.dumps({"training_run": run_t, "solves": solve_t, "cli": cli_t}))

    # ---- phase 12: the kernels line (launches: the main path's run; the
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
                    launches_per_solve_inner_step=solve_t[
                        "launches_per_inner_step"][name],
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
                "m", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                for sh, r in repaired[k["name"]].items()}
    for k in kernels:
        if k["name"] in regs:
            k["registers"] = regs[k["name"]]
    # the segment engine (phase 8b): its launches a train step (checked in
    # that phase's run) and a rollout step, and K2/K3 at its part forms
    for k in kernels:
        k["segment"] = dict(
            launches_per_train_step=SEG_TRAIN.get(k["name"], 0),
            launches_per_rollout_step=SEG_FWD.get(k["name"], 0),
            launches_in_3_train_steps=seg_t["train_launches"][k["name"]])
        if k["name"] in ("fused_mlp_ln", "fused_mlp_ln_bwd"):
            k["segment"]["forms"] = {form: {f: r[k["name"]][f] for f in (
                "m", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                for form, r in seg_forms.items()}
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
