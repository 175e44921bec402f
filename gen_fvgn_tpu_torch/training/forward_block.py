"""Block-engine forward pass: normalization → GNN backbone → BC enforcement
→ IMEX time mixing → FV residual → re-dimensionalization.

Counterpart of `gen_fvgn_tpu/training/forward_block.py::forward_batch_block`.
The StaticPack is shared across the batch; per-environment dynamics are
stacked [B, ...]; where the JAX function vmaps a per-sample body, the batch
axis is written out here. The FV residual runs on channel-major packed
arrays (fv/integrator_block_packed.py) whatever `fv_packed` says: JAX's
`fv_packed=False` vmaps a per-sample body over the same operators, and
here both settings run the same CSR products, whose losses are per sample
anyway (they agree with JAX's per-sample losses within float32 summation
order), as `fv_ell` does.

Under spatial parallelism (`parallel/sp.py::sp_context`) `dyn` and
`static` hold the rank's node, face and cell rows: the applies gather
their operands over the sp group, and the sums over rows (norm_uvp's
statistics here, the slice pool's tokens, the FV losses) are all-reduced
over it, so every rank holds the whole batch's losses. `norm_reduce` sums
the normalizer's rows over every rank that holds other rows.
"""

from __future__ import annotations

import torch

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.fv.integrator_block_packed import (
    integrate_residuals_block_packed)
from gen_fvgn_tpu_torch.graph.packs import DynamicPack, StaticPack
from gen_fvgn_tpu_torch.ops.blocksparse import apply_linop, sp_layout
from gen_fvgn_tpu_torch.ops.segment import masked_mean_var
from gen_fvgn_tpu_torch.parallel.sp import sp_sum
from gen_fvgn_tpu_torch.training import normalizer as norm_mod
from gen_fvgn_tpu_torch.training.forward import (ForwardOutputs,
                                                 enforce_boundary_conditions)
from gen_fvgn_tpu_torch.training.normalizer import NormalizerState
from gen_fvgn_tpu_torch.utils.spans import span


def forward_batch_block(
    simulator,                    # nn.Module: (x, edge_attr, static) -> uvp
    norm_state: NormalizerState,
    dyn: DynamicPack,             # stacked [B, ...]
    static: StaticPack,           # shared
    cfg: Config,
    accumulate_normalizer: bool = True,
    norm_reduce=None,
) -> ForwardOutputs:
    b, n_pad = dyn.uvp.shape[0], dyn.uvp.shape[1]
    theta_nodes = dyn.theta[:, None, :].expand(b, n_pad, dyn.theta.shape[-1])
    x = torch.cat([dyn.uvp, theta_nodes], dim=-1)              # [B,Np,12]
    mask_b = static.node_mask[None].expand(b, n_pad)

    phi = x[..., : cfg.node_phi_size]
    if cfg.norm_uvp:
        mean, var = masked_mean_var(
            phi, mask_b, axis=1,
            reduce=sp_sum if sp_layout() is not None else None)
        phi = (phi - mean) / (torch.sqrt(var) + 1e-8)

    theta_ch = x[..., cfg.node_phi_size:]
    if cfg.norm_global:
        theta_ch, norm_state = norm_mod.normalize(
            norm_state, theta_ch, mask_b,
            max_accumulations=float(cfg.dataset_size),
            accumulate=accumulate_normalizer, reduce=norm_reduce)
    x = torch.cat([phi, theta_ch], dim=-1)

    # the θ channels of dx are identically zero (per-graph constants); they
    # stay in the [E, 15] edge input because the encoder's W1 has rows for
    # them in the parameter tree
    dx = apply_linop(static.ops.edge_diff, x)                  # [B,E,12]
    edge_attr = torch.cat(
        [dx, static.edge_pos_feat[None].expand(b, -1, -1)], dim=-1)
    uvp_new = simulator(x, edge_attr, static)
    # soft clamp in the backbone's output type (bf16 on the bf16 stream, as
    # in the JAX package); the Dirichlet overwrite then promotes to float32
    uvp_new = torch.tanh(uvp_new / 10.0) * 10.0
    uvp_new = enforce_boundary_conditions(uvp_new, static.node_type,
                                          dyn.target_uv)
    uv_old = dyn.uvp[..., 0:2] / dyn.uvp_dim[:, None, 0:2]
    if cfg.integrator == "explicit":
        uv_hat = uv_old
    elif cfg.integrator == "implicit":
        uv_hat = uvp_new[..., 0:2]
    elif cfg.integrator == "imex":
        uv_hat = 0.5 * (uv_old + uvp_new[..., 0:2])
    else:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")

    # FV residual ONCE for the whole batch (channel-major packed arrays)
    with span("gfvgn.fv.residual"):
        losses, rt_uvp, uvp_cell = integrate_residuals_block_packed(
            uvp_new, uv_hat, uv_old, dyn, static,
            order=cfg.order, conserved_form=cfg.conserved_form,
            ncn_smooth=cfg.ncn_smooth, fv_ell=cfg.fv_ell)
    rt_uvp = enforce_boundary_conditions(rt_uvp, static.node_type,
                                         dyn.target_uv)
    scale = (dyn.uvp_dim * dyn.sigma)[:, None, :]              # [B,1,3]
    return ForwardOutputs(
        loss_cont=losses.cont.reshape(b, 1),
        loss_mom_x=losses.mom_x.reshape(b, 1),
        loss_mom_y=losses.mom_y.reshape(b, 1),
        loss_press=losses.press.reshape(b, 1),
        uvp_node_new=rt_uvp * scale,
        uvp_cell_new=uvp_cell * scale,
        norm_state=norm_state,
    )
