"""ops — counterpart of the JAX package's sub-package of the same name.

`plain_versions()` is the one switch between the kernels and their plain
PyTorch versions: inside it the dispatching callers (`apply_linop`,
`apply_half_agg` / `apply_node_agg`, `apply_gather_pair`, `apply_node_pair`,
`fused_mlp_ln_parts`,
`fused_mlp_noln_parts`, `fused_premlp_res_parts`, `fused_slice_pool`) call
`spmm_reference`, `pair_sum_reference`, `fused_mlp_ln_reference`,
`fused_mlp_noln_reference`, `fused_premlp_res_reference` and
`fused_slice_pool_reference` on whatever device the data is on, and their
autograd Functions take the backward's plain versions
(`pair_transpose_reference`, `fused_mlp_ln_bwd_reference`,
`fused_mlp_noln_bwd_reference`, `fused_premlp_res_bwd_reference`,
`fused_slice_pool_bwd_reference`). It is
entered only by the eval step's `plain_kernels=True` argument and by
`chip_smoke.py` (the on-card comparisons of a kernel step with a plain
step, and of their gradients) and by tests.
The kernel wrappers themselves never consult it: on a CUDA tensor they
launch their kernel or raise.
"""

import contextlib

_PLAIN_VERSIONS = False


def plain_versions_active() -> bool:
    return _PLAIN_VERSIONS


@contextlib.contextmanager
def plain_versions():
    global _PLAIN_VERSIONS
    old = _PLAIN_VERSIONS
    _PLAIN_VERSIONS = True
    try:
        yield
    finally:
        _PLAIN_VERSIONS = old
