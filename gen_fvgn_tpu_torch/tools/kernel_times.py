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
* K6 at (128, 8, 32) and at (256, 8, 32) (`check_slice_pool`), K5f
  (`check_premlp`), K5b and K7 (`check_backward`), each also held against
  its plain version by the tree's check.

Run it by path, not as a module: it imports `chip_smoke` and
`gen_fvgn_tpu_torch` from the tree it is given. Needs one CUDA card.
"""

import inspect
import json
import os
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


def main(argv):
    root, label = os.path.abspath(argv[0]), argv[1]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from gen_fvgn_tpu_torch.ops import _cuda_build
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
    rows = {"fused_premlp_res": cs.check_premlp(n_pad, flush, gen),
            "fused_slice_pool": cs.check_slice_pool(static, flush, gen)}
    rows.update(cs.check_backward(n_pad, static, flush, gen))
    rows["fused_slice_pool_c256"] = cs.check_slice_pool(
        static, flush, torch.Generator(device="cuda").manual_seed(256), 256)
    times = {"spmm": {k: round(v, 4) for k, v in k1.items()},
             "spmm_train_step": round(step, 4)}
    times.update({k: round(v["ms"], 4) for k, v in rows.items()})
    print("TIMES", label, json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
