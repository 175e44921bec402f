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
`fused_slice_pool_bwd_reference`). It is entered by `chip_smoke.py` (the
on-card comparisons of a kernel step with a plain step, and of their
gradients) and by tests.

`mesh_lists(batch, cfg)` is the segment engine's one dispatch: it builds
the lists its kernels run on (`MeshLists`: the GraphNet blocks' incidence
lists, `segment_csr.build_incidence`, and the FV residual's,
`fv_csr.build_lists`), or returns None, the plain versions, for CPU
tensors and inside `plain_versions()`. The entry points build them once a
batch (`training.forward.forward_batch` where it is given none, once a
`solve.rollout.rollout` request, once a `solve.instance_opt` time step
where it runs unchunked) and pass them down; nothing below rebuilds them.
The kernel wrappers themselves never consult the switch: on a CUDA tensor
they launch their kernel or raise.
"""

import contextlib
from typing import TYPE_CHECKING, NamedTuple, Optional

if TYPE_CHECKING:
    from gen_fvgn_tpu_torch.ops.fv_csr import FvLists
    from gen_fvgn_tpu_torch.ops.segment_csr import Incidence

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


class MeshLists(NamedTuple):
    """A batch's lists for the segment engine's kernels, which depend on
    its topology alone."""
    inc: "Incidence"            # the GraphNet blocks'
    fv: Optional["FvLists"]     # the FV residual's; None at the forms its
    #                             kernels do not cover


def mesh_lists(batch, cfg) -> Optional[MeshLists]:
    """The lists of the stacked MeshSample `batch` on its device, or None
    (the plain versions) for CPU tensors and inside `plain_versions()`.
    `fv` is built at order "2nd" in the conserved form (`cfg`), the forms
    the FV kernels cover, and is None at every other."""
    if not batch.face_node.is_cuda or _PLAIN_VERSIONS:
        return None
    from gen_fvgn_tpu_torch.ops import fv_csr, segment_csr
    inc = segment_csr.build_incidence(batch.face_node, batch.face_mask,
                                      batch.uvp.shape[1])
    fv = (fv_csr.build_lists(batch)
          if cfg.order == "2nd" and cfg.conserved_form else None)
    return MeshLists(inc, fv)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process, by kernel."""
    from gen_fvgn_tpu_torch.ops import (fused_mlp, fused_slice_attn, fv_csr,
                                        pair_spmm, segment_csr, spmm)
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
                fused_slice_pool_bwd=fused_slice_attn.LAUNCHES_BWD,
                fused_mlp_ln_wg=fused_mlp.LAUNCHES_LN_WG,
                fused_mlp_ln_bwd_wg=fused_mlp.LAUNCHES_LN_BWD_WG,
                seg_nbr_sum=segment_csr.LAUNCHES_NBR_SUM,
                seg_inc_sum=segment_csr.LAUNCHES_INC_SUM,
                seg_collect=segment_csr.LAUNCHES_COLLECT,
                fv_lists=fv_csr.LAUNCHES_FV_LISTS,
                fv_wlsq=fv_csr.LAUNCHES_FV_WLSQ,
                fv_face=fv_csr.LAUNCHES_FV_FACE,
                fv_cell=fv_csr.LAUNCHES_FV_CELL,
                fv_loss=fv_csr.LAUNCHES_FV_LOSS,
                fv_smooth=fv_csr.LAUNCHES_FV_SMOOTH,
                fv_cell_bwd=fv_csr.LAUNCHES_FV_CELL_BWD,
                fv_node_bwd=fv_csr.LAUNCHES_FV_NODE_BWD,
                fv_wlsq_bwd=fv_csr.LAUNCHES_FV_WLSQ_BWD)


def zero_launch_counts() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from gen_fvgn_tpu_torch.ops import (fused_mlp, fused_slice_attn, fv_csr,
                                        pair_spmm, segment_csr, spmm)
    spmm.LAUNCHES = 0
    pair_spmm.LAUNCHES_PAIR_SUM = pair_spmm.LAUNCHES_PAIR_TRANSPOSE = 0
    fused_mlp.LAUNCHES_LN = fused_mlp.LAUNCHES_NOLN = 0
    fused_mlp.LAUNCHES_PREMLP = 0
    fused_mlp.LAUNCHES_LN_BWD = fused_mlp.LAUNCHES_NOLN_BWD = 0
    fused_mlp.LAUNCHES_PREMLP_BWD = 0
    fused_mlp.LAUNCHES_LN_WG = fused_mlp.LAUNCHES_LN_BWD_WG = 0
    fused_slice_attn.LAUNCHES = fused_slice_attn.LAUNCHES_BWD = 0
    segment_csr.LAUNCHES_NBR_SUM = segment_csr.LAUNCHES_INC_SUM = 0
    segment_csr.LAUNCHES_COLLECT = 0
    for name in ("LISTS", "WLSQ", "FACE", "CELL", "LOSS", "SMOOTH",
                 "CELL_BWD", "NODE_BWD", "WLSQ_BWD"):
        setattr(fv_csr, f"LAUNCHES_FV_{name}", 0)
