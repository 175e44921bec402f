"""Times the sparse apply K1 and the Transolver kernels of a tree at the
main path's shapes, so that two trees (a change and its parent) are timed
by the same method in one run:

    python3 gen_fvgn_tpu_torch/tools/kernel_times.py <tree root> <label>

Builds the tree's kernels, sets up its main path's statics (batch 8, the
101x101-node cavity), and prints one line `TIMES <label> {...}` with the
median ms (CUDA events, cold L2, the tree's own `chip_smoke.median_ms`)
of

* K1 in every form a train step of that tree launches, and their sum
  weighted by the launches a train step makes: adj and its transpose, the
  gathers' transposes, and the composed node aggregation's applies — at
  full width (nbr_r, nbr_s and their transposes on [.., 128]) where the
  tree's `spmm` takes no column window, on the 64-column windows where it
  does;
* K8 (`pair_sum`) in both forms: the gather pair (gather_s / gather_r on
  [8, N, 256]) and the node pair (nbr_r / nbr_s on [8, E, 128]);
* K9 (`pair_transpose`) on the node pair's transposes (nbr_r.bwd /
  nbr_s.bwd on [8, N, 64]);
* the registers of every K1 and K8 instantiation, from the tree's build
  log (`-Xptxas -v`), so that a change to their shared row code shows;
* K6 at (128, 8, 32) and at (256, 8, 32) (`check_slice_pool`), K5f
  (`check_premlp`), K5b and K7 (`check_backward`), and K5f and K5b at C =
  256 (hidden 512, the same rows), each also held against its plain
  version by the tree's check;
* K2 and K3 at the block engine's edge form (a 128-wide part, a pre, the
  residual with both outputs) and node form (parts 64 + 128, the residual
  on the second) and at the
  segment engine's two part forms (the edge MLP's 384-wide part, the node
  MLP's 192-wide part padded to 256), by the tree's `check_fused_ln`,
  `check_mlp_backward` and `check_segment_forms`, and K3's kernels at the
  384-wide part under torch.profiler (device ms a call by kernel: the row
  pass, `fused_mlp_wgrad`, `lane_reduce`);
* K3 at the encoders' pre-only forms (no first-layer part, a pre, M = 8 x
  nodes and 8 x faces), held against its plain version;
* the registers and spills of every fused MLP kernel;
* where the tree has them, the segment FV residual's list passes
  (`check_fv_csr`: the lists' build, F1 `wlsq`, F2 `face`, F3 `cell` with
  the loss pass, F4 `smooth` and the three backward passes, each timed
  alone at the benchmark cells' shape, the 201 x 201-node cavity at batch
  8), each beside its byte bound and the plain stage's time (`plain_ms`),
  and the whole residual's forward and backward against the plain chain.

Run it by path, not as a module: it imports `chip_smoke` and
`gen_fvgn_tpu_torch` from the tree it is given. Needs one CUDA card.
"""

import inspect
import json
import os
import re
import sys


def spmm_forms(static, windows):
    """(name, operator, operand, output or None, launches a train step)
    of the tree's K1 forms at [8, n, 128] bf16."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    ops = static.ops
    rnd = lambda n, w: torch.randn(8, n, w, generator=g,
                                   device="cuda").to(torch.bfloat16)
    forms = []
    for name, op in (("adj", ops.adj.fwd), ("adj^T", ops.adj.bwd),
                     ("gather_s^T", ops.gather_s.bwd),
                     ("gather_r^T", ops.gather_r.bwd)):
        forms.append((name, op, rnd(op.n_in, 128), None, 6))
    for which, c0 in (("nbr_r", 0), ("nbr_s", 64)):
        fwd, bwd = getattr(ops, which).fwd, getattr(ops, which).bwd
        if windows:
            e = rnd(fwd.n_in, 128)
            forms.append((f"{which}[{c0}:{c0 + 64}]", fwd,
                          e[..., c0:c0 + 64], None, 6))
            de = torch.empty(8, bwd.n_out, 128, device="cuda",
                             dtype=torch.bfloat16)
            forms.append((f"{which}^T->[{c0}:{c0 + 64}]", bwd,
                          rnd(bwd.n_in, 64), de[..., c0:c0 + 64], 6))
        else:
            forms.append((which, fwd, rnd(fwd.n_in, 128), None, 6))
            forms.append((f"{which}^T", bwd, rnd(bwd.n_in, 128), None, 6))
    return forms


def pair_forms(static):
    """(name, A, B, operand width) of K8's two forms on the paired path:
    the EdgeBlock's gather pair (E <- N, H = 128) and the NodeBlock's node
    pair (N <- E, H = 64)."""
    ops = static.ops
    return [("gather_pair", ops.gather_s.fwd, ops.gather_r.fwd, 256),
            ("node_pair", ops.nbr_r.fwd, ops.nbr_s.fwd, 128)]


def mlp_times(cs, n_pad, e_pad, flush):
    """K2 and K3 at the block engine's forms and the segment engine's part
    forms, by the tree's checks (each against its plain version): {name:
    ms}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {}
    for r in cs.check_fused_ln(n_pad, e_pad, flush, gen):
        for key in ("edge", "node"):
            if r["variant"].startswith(key):
                out[f"K2 block {key}"] = r["ms"]
    out["K3 block edge"] = cs.check_mlp_backward(
        n_pad, e_pad, flush, gen)["fused_mlp_ln_bwd"]["ms"]
    # the block node MLP: parts 64 + 128, the residual on the second
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    m = cs.BATCH * n_pad
    parts, w1s, b1, w2, b2, w3, b3, gamma, _, _ = _mlp_case(
        gen, m, [64, 128], False, 192)
    dout = torch.randn(m, 128, generator=gen, device="cuda").to(
        torch.bfloat16)
    args = (parts, w1s, b1, w2, b2, w3, b3, gamma, (), [dout], 1, False,
            cs.BATCH)
    out["K3 block node"] = cs.hold_backward(
        "fused_mlp_ln_bwd[block node]", lambda: fm.fused_mlp_ln_bwd(*args),
        lambda: fm.fused_mlp_ln_bwd_reference(*args), flush)[1]["ms"]
    # the encoders: a pre and no first-layer part
    for key, m in (("node", cs.BATCH * n_pad), ("edge", cs.BATCH * e_pad)):
        _, _, b1, w2, b2, w3, b3, gamma, _, pres = _mlp_case(
            gen, m, [], True, 128)
        dout = torch.randn(m, 128, generator=gen, device="cuda").to(
            torch.bfloat16)
        args = ([], [], b1, w2, b2, w3, b3, gamma, pres, [dout], None,
                False, cs.BATCH)
        out[f"K3 {key} encoder"] = cs.hold_backward(
            f"fused_mlp_ln_bwd[{key} encoder]",
            lambda: fm.fused_mlp_ln_bwd(*args),
            lambda: fm.fused_mlp_ln_bwd_reference(*args), flush)[1]["ms"]
    for form, r in cs.check_segment_forms(n_pad, e_pad, flush, gen).items():
        key = "edge 384" if form.startswith("edge") else "node 256"
        out[f"K2 segment {key}"] = r["fused_mlp_ln"]["ms"]
        out[f"K3 segment {key}"] = r["fused_mlp_ln_bwd"]["ms"]
    return out


def _mlp_case(gen, m, widths, has_pre, k_total, h=128):
    """Operands of K2/K3 at a form: parts owning the last rows of a W1 of
    k_total rows, weights scaled as the nets' initialisers scale them."""
    import torch
    bf = torch.bfloat16
    g = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    w1 = g(k_total, h) / k_total ** 0.5
    w1s, off = [], k_total - sum(widths)
    for k in widths:
        w1s.append(w1[off:off + k].to(bf).contiguous())
        off += k
    return ([g(m, k).to(bf) for k in widths], w1s, 0.1 * g(h),
            (g(h, h) / h ** 0.5).to(bf), 0.1 * g(h),
            (g(h, h) / h ** 0.5).to(bf), 0.1 * g(h), 1 + 0.1 * g(h),
            0.1 * g(h), [g(m, h).to(bf)] if has_pre else [])


def k3_profile(e_pad):
    """K3 at the segment edge MLP's 384-wide part (8 lanes of the padded
    faces) under torch.profiler: device ms a call of each of its kernels
    (the row pass, the weight-gradient pass, the reductions)."""
    import torch
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.tools.profile_rollout import device_profile
    import chip_smoke as cs
    gen = torch.Generator(device="cuda").manual_seed(183)
    m = cs.BATCH * e_pad
    parts, w1s, b1, w2, b2, w3, b3, gamma, _, _ = _mlp_case(
        gen, m, [384], False, 384)
    dout = torch.randn(m, 128, generator=gen, device="cuda").to(
        torch.bfloat16)
    args = (parts, w1s, b1, w2, b2, w3, b3, gamma, (), [dout], None, False,
            cs.BATCH)
    fm.fused_mlp_ln_bwd(*args)

    def window(n):
        for _ in range(n):
            fm.fused_mlp_ln_bwd(*args)
    _, rows = device_profile(window, 10)
    return {_kernel_name(k): [round(ms, 4), calls] for ms, calls, k in rows}


def _kernel_name(name):
    """A fused MLP kernel's name with its template arguments, from a
    mangled (ptxas) or demangled (profiler) name; other names as given."""
    m = re.search(r"\d*(fused_mlp_(?:fwd_|bwd_)?(?:rows|tiles|wgrad|wg)"
                  r"|lane_reduce)(I(?:Lb[01]E)+E|<[^>]*>)?", name)
    if m is None:
        return name
    args = m.group(2) or ""
    if args.startswith("I"):
        args = "<" + ", ".join("true" if b == "1" else "false"
                               for b in re.findall(r"Lb([01])E", args)) + ">"
    return m.group(1) + args


def main(argv):
    root, label = os.path.abspath(argv[0]), argv[1]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from gen_fvgn_tpu_torch.ops import _cuda_build
    from gen_fvgn_tpu_torch.ops.pair_spmm import pair_sum, pair_transpose
    from gen_fvgn_tpu_torch.ops.spmm import spmm
    from gen_fvgn_tpu_torch.tools.profile_rollout import build_main_path
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda_build.load_library()
    _, _, static, _, _, _ = build_main_path(batch=8, mesh_n=100, seed=0)
    n_pad = static.pos.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.zeros(64 * 1024 * 1024, device="cuda")
    windows = "out" in inspect.signature(spmm).parameters
    k1 = {}
    for name, op, x, out, _ in spmm_forms(static, windows):
        run = ((lambda: spmm(op, x, out=out)) if out is not None
               else (lambda: spmm(op, x)))
        k1[name] = cs.median_ms(run, flush)
    step = sum(k1[name] * n for name, _, _, _, n in
               spmm_forms(static, windows))
    k8, gen8 = {}, torch.Generator(device="cuda").manual_seed(8)
    for name, a, b, width in pair_forms(static):
        y = torch.randn(8, a.n_in, width, generator=gen8,
                        device="cuda").to(torch.bfloat16)
        k8[name] = cs.median_ms(lambda: pair_sum(a, b, y), flush)
    a9, b9 = static.ops.nbr_r.bwd, static.ops.nbr_s.bwd
    g9 = torch.randn(8, a9.n_in, 64, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda").to(torch.bfloat16)
    k9 = cs.median_ms(lambda: pair_transpose(a9, b9, g9), flush)
    regs = {u["function"]: u["registers"] for frag in ("spmm_csr_kernel",
                                                       "pair_sum_kernel")
            for u in cs.ptxas_usage(_cuda_build.BUILD_LOG, frag)}
    rows = {"fused_premlp_res": cs.check_premlp(n_pad, flush, gen),
            "fused_slice_pool": cs.check_slice_pool(static, flush, gen)}
    rows.update(cs.check_backward(n_pad, static, flush, gen))
    g256 = torch.Generator(device="cuda").manual_seed(256)
    rows["fused_slice_pool_c256"] = cs.check_slice_pool(static, flush, g256,
                                                        256)
    rows["fused_premlp_res_c256"] = cs.check_premlp(n_pad, flush, g256, 256)
    rows["fused_premlp_res_bwd_c256"] = cs.check_backward(
        n_pad, static, flush, g256, 256, pool=False)["fused_premlp_res_bwd"]
    times = {"spmm": {k: round(v, 4) for k, v in k1.items()},
             "spmm_train_step": round(step, 4),
             "pair_sum": {k: round(v, 4) for k, v in k8.items()},
             "pair_transpose": round(k9, 4),
             "registers_k1_k8": {
                 re.sub(r".*?(spmm_csr|pair_sum)_kernelI(.*)EEEvNS_.*",
                        r"\1<\2>", k): v for k, v in sorted(regs.items())}}
    times.update({k: round(v["ms"], 4) for k, v in rows.items()})
    e_pad = static.edge_pos_feat.shape[0]
    times["fused_mlp"] = {k: round(v, 4) for k, v in
                          mlp_times(cs, n_pad, e_pad, flush).items()}
    times["k3_segment_edge_profile"] = k3_profile(e_pad)
    if hasattr(cs, "check_fv_csr"):
        fv = cs.check_fv_csr(flush, torch.Generator(device="cuda").manual_seed(
            25))
        times["fv_csr"] = {form: {k: round(v, 4) for k, v in r.items()
                                  if k in ("ms", "bound_ms", "plain_ms")}
                           for form, r in fv.items()}
    times["registers_fused_mlp"] = {
        _kernel_name(u["function"]): [u["registers"], u["spill_stores"],
                                      u["spill_loads"]]
        for u in cs.ptxas_usage(_cuda_build.BUILD_LOG, "fused_mlp_")}
    print("TIMES", label, json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
