"""GraphNet message-passing blocks on padded meshes (the segment engine),
and the Encoder and Decoder of every backbone.

Counterpart of `gen_fvgn_tpu/models/gn.py` (`_twoway_sum`, `EdgeBlock`,
`NodeBlock`, `GnBlock`, `Encoder`, `Decoder`), with the same parameter
tree. Batch-major: node_x [B, N, h], edge_attr [B, E, h], face_node
[B, 2, E] (each sample's own faces), face_mask [B, E]. Two-way aggregation
is two masked segment sums over the stored one-way face list, in the
stream's type; the NodeBlock splits the learned edge features in half, one
half a direction. The MLPs see one concatenated input part, as in JAX: the
EdgeBlock's [agg@sender, agg@receiver, edge_attr] (3h wide), the
NodeBlock's [nbr_avg, node_x] (h/2 + h wide); the residual adds of GnBlock
are outside the MLPs.

Given the batch's incidence lists (`inc`, `ops/segment_csr.py`, built by
`ops.mesh_lists` at the entry point and passed down through the
simulator) each transfer is one kernel pass over them, with the plain
version's bits:
the EdgeBlock's `agg` and the NodeBlock's second hop are `nbr_sum`, the
NodeBlock's directed sums `inc_sum`, the edge MLP's input `collect`, and
the degree the lists' lengths. Without lists (CPU tensors, or inside
`ops.plain_versions()`) they run the masked segment sums and row gathers
of `ops/segment.py`; a CUDA tensor without lists outside
`ops.plain_versions()` raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.models.mlp import Mlp
from gen_fvgn_tpu_torch.ops import segment_csr as csr
from gen_fvgn_tpu_torch.ops.segment import gather_rows, segment_sum


def _twoway_sum(values_s, values_r, face_node, n_nodes: int, face_mask):
    """out[r] += values_s and out[s] += values_r over all faces (s, r)."""
    s, r = face_node[:, 0], face_node[:, 1]
    return (segment_sum(values_s, r, n_nodes, face_mask) +
            segment_sum(values_r, s, n_nodes, face_mask))


def _check_plain(x: torch.Tensor):
    """The plain transfers run on the CPU, or on the card where the plain
    versions are asked for; a block on the card has no other fallback."""
    from gen_fvgn_tpu_torch.ops import plain_versions_active
    if x.is_cuda and not plain_versions_active():
        raise RuntimeError("a GraphNet block on CUDA tensors needs the "
                           "batch's incidence lists (`inc`)")


class EdgeBlock(nn.Module):
    """Edge update: per-node sum of the neighbours' node features (two-way),
    then MLP([agg@sender, agg@receiver, edge_attr])."""

    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_mlp = Mlp(3 * hidden_size, hidden_size, hidden_size,
                            dtype=dtype, generator=generator)

    def forward(self, node_x, edge_attr, face_node, face_mask, inc=None):
        if inc is not None:
            agg = csr.nbr_sum(node_x, inc)
            return self.edge_mlp(csr.collect(agg, edge_attr, inc))
        _check_plain(node_x)
        n_nodes = node_x.shape[1]
        s, r = face_node[:, 0], face_node[:, 1]
        agg = _twoway_sum(gather_rows(node_x, s), gather_rows(node_x, r),
                          face_node, n_nodes, face_mask)
        collected = torch.cat([gather_rows(agg, s), gather_rows(agg, r),
                               edge_attr], dim=-1)
        return self.edge_mlp(collected)


class NodeBlock(nn.Module):
    """Node update with the direction-chunk trick: the edge features' first
    half flows s→r, the second r→s; a second hop averages the neighbours'
    aggregates; MLP([avg (h/2), x (h)])."""

    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_mlp = Mlp(hidden_size // 2 + hidden_size, hidden_size,
                            hidden_size, dtype=dtype, generator=generator)

    def forward(self, node_x, edge_attr, face_node, face_mask, inc=None):
        if inc is not None:
            half = edge_attr.shape[-1] // 2
            agg = csr.inc_sum(edge_attr, inc, 0, half, half)    # [B, N, h/2]
            nbr_sum = csr.nbr_sum(agg, inc)
            deg = inc.deg.to(node_x.dtype)
        else:
            _check_plain(node_x)
            nbr_sum, deg = self._plain_sums(node_x, edge_attr, face_node,
                                            face_mask)
        nbr_avg = nbr_sum / torch.clamp(deg, min=1.0)
        return self.node_mlp(torch.cat([nbr_avg, node_x], dim=-1))

    @staticmethod
    def _plain_sums(node_x, edge_attr, face_node, face_mask):
        n_nodes = node_x.shape[1]
        s, r = face_node[:, 0], face_node[:, 1]
        half_a, half_b = torch.chunk(edge_attr, 2, dim=-1)
        agg = (segment_sum(half_a, r, n_nodes, face_mask) +
               segment_sum(half_b, s, n_nodes, face_mask))      # [B, N, h/2]
        nbr_sum = _twoway_sum(gather_rows(agg, s), gather_rows(agg, r),
                              face_node, n_nodes, face_mask)
        ones = torch.ones(face_node.shape[:1] + face_node.shape[2:] + (1,),
                          dtype=node_x.dtype, device=node_x.device)
        return nbr_sum, _twoway_sum(ones, ones, face_node, n_nodes,
                                    face_mask)


class GnBlock(nn.Module):
    """EdgeBlock → NodeBlock with residual connections on both streams."""

    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_block = EdgeBlock(hidden_size, dtype, generator)
        self.node_block = NodeBlock(hidden_size, dtype, generator)

    def forward(self, node_x, edge_attr, face_node, face_mask, inc=None):
        """`inc`: the batch's incidence lists, or None (the plain
        versions)."""
        edge_new = self.edge_block(node_x, edge_attr, face_node, face_mask,
                                   inc)
        node_new = self.node_block(node_x, edge_new, face_node, face_mask,
                                   inc)
        return node_x + node_new, edge_attr + edge_new


class Encoder(nn.Module):
    def __init__(self, node_input_size: int, edge_input_size: int,
                 hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_encoder = Mlp(node_input_size, hidden_size, hidden_size,
                                dtype=dtype, generator=generator)
        self.edge_encoder = Mlp(edge_input_size, hidden_size, hidden_size,
                                dtype=dtype, generator=generator)

    def forward(self, node_feats, edge_feats):
        return self.node_encoder(node_feats), self.edge_encoder(edge_feats)


class Decoder(nn.Module):
    def __init__(self, out_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_decoder = Mlp(hidden_size, hidden_size, out_size,
                                layer_norm=False, dtype=dtype,
                                generator=generator)

    def forward(self, node_h):
        return self.node_decoder(node_h)
