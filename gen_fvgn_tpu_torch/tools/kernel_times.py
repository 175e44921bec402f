"""Times the Transolver kernels of a tree at the main path's shapes with
that tree's own `chip_smoke.py` check functions, so that two trees (a
change and its parent) are timed by the same method in one run:

    python3 gen_fvgn_tpu_torch/tools/kernel_times.py <tree root> <label>

Builds the tree's kernels, sets up its main path's statics (batch 8, the
101x101-node cavity), and prints one line `TIMES <label> {...}` with the
median ms of K5f (`check_premlp`), K6 (`check_slice_pool`), K5b and K7
(`check_backward`), each also held against its plain version by the check.
Run it by path, not as a module: it imports `chip_smoke` and
`gen_fvgn_tpu_torch` from the tree it is given. Needs one CUDA card.
"""

import json
import os
import sys


def main(argv):
    root, label = os.path.abspath(argv[0]), argv[1]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from gen_fvgn_tpu_torch.ops import _cuda_build
    from gen_fvgn_tpu_torch.tools.profile_rollout import build_main_path
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda_build.load_library()
    _, _, static, _, _, _ = build_main_path(batch=8, mesh_n=100, seed=0)
    n_pad = static.pos.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.zeros(64 * 1024 * 1024, device="cuda")
    rows = {"fused_premlp_res": cs.check_premlp(n_pad, flush, gen),
            "fused_slice_pool": cs.check_slice_pool(static, flush, gen)}
    rows.update(cs.check_backward(n_pad, static, flush, gen))
    print("TIMES", label, json.dumps({k: round(v["ms"], 4)
                                      for k, v in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
