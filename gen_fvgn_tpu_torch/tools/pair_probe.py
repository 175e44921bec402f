"""Where K9's time goes at the paired path's shapes, on one NVIDIA card:

    python -m gen_fvgn_tpu_torch.tools.pair_probe

Builds the kernels and the main path's statics (batch 8, the 101x101-node
cavity) and prints the median ms (CUDA events, cold L2: `chip_smoke.
median_ms`) of K9 (`pair_transpose`, g [8, N, 64] bf16 -> [8, E, 128]) on

* the node pair's transposes nbr_r.bwd / nbr_s.bwd (the paired path's);
* operators of the same shape and count (four non-zeros a row in each)
  whose columns are random: no locality in g;
* operators whose every row reads the same eight rows of g (four in each):
  every gathered row in L1;

and of a plain write of K9's output tensor (`fill_`), the floor of its
bytes. If K9 costs about the same on all three operators, neither L2
bandwidth nor the locality of g bounds it.
"""

import sys

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("pair_probe needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gen_fvgn_tpu_torch.ops import _cuda_build
    from gen_fvgn_tpu_torch.ops.blocksparse import build_csr_op
    from gen_fvgn_tpu_torch.ops.pair_spmm import pair_transpose
    from gen_fvgn_tpu_torch.tools.profile_rollout import build_main_path
    _cuda_build.load_library()
    _, _, static, _, _, _ = build_main_path(batch=8, mesh_n=100, seed=0)
    flush = torch.zeros(64 * 1024 * 1024, device="cuda")
    a, b = static.ops.nbr_r.bwd, static.ops.nbr_s.bwd
    g = torch.randn(8, a.n_in, 64, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda").to(torch.bfloat16)
    n_real = int((a.crow[1:] > a.crow[:-1]).sum())
    rows = np.repeat(np.arange(n_real), 4)

    def op(cols):
        return build_csr_op(rows, cols, np.ones(rows.shape[0], np.float32),
                            a.n_out, a.n_in, "bfloat16").to("cuda")

    rng = np.random.default_rng(0)
    cases = {
        "node pair": (a, b),
        "random columns": (op(rng.integers(0, a.n_in, rows.shape[0])),
                           op(rng.integers(0, a.n_in, rows.shape[0]))),
        "the same eight rows": (op(np.tile(np.arange(4), n_real)),
                                op(np.tile(np.arange(4, 8), n_real)))}
    card = torch.cuda.get_device_name(0)
    for name, (p, q) in cases.items():
        ms = cs.median_ms(lambda: pair_transpose(p, q, g), flush)
        print(f"K9 on {name} (nnz {p.nnz} + {q.nnz}): {ms:.4f} ms ({card})")
    out = pair_transpose(a, b, g)
    ms = cs.median_ms(lambda: out.fill_(1.0), flush)
    print(f"a write of its output [{', '.join(map(str, out.shape))}] bf16 "
          f"({out.numel() * 2 / 1e6:.1f} MB): {ms:.4f} ms ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
