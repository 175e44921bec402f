"""ops — counterpart of the JAX package's sub-package of the same name.

`plain_versions()` is the one switch between the kernels and their plain
PyTorch versions: inside it the dispatching callers (`apply_linop`,
`fused_mlp_ln_parts`, `fused_mlp_noln_parts`) call `spmm_reference`,
`fused_mlp_ln_reference` and `fused_mlp_noln_reference` on whatever device
the data is on. It is entered only by the eval step's `plain_kernels=True`
argument (the on-card comparison of a kernel step with a plain step) and by
tests. The kernel wrappers themselves never consult it: on a CUDA tensor
they launch their kernel or raise.
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
