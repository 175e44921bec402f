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
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.models.mlp import Mlp
from gen_fvgn_tpu_torch.ops.segment import gather_rows, segment_sum


def _twoway_sum(values_s, values_r, face_node, n_nodes: int, face_mask):
    """out[r] += values_s and out[s] += values_r over all faces (s, r)."""
    s, r = face_node[:, 0], face_node[:, 1]
    return (segment_sum(values_s, r, n_nodes, face_mask) +
            segment_sum(values_r, s, n_nodes, face_mask))


class EdgeBlock(nn.Module):
    """Edge update: per-node sum of the neighbours' node features (two-way),
    then MLP([agg@sender, agg@receiver, edge_attr])."""

    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_mlp = Mlp(3 * hidden_size, hidden_size, hidden_size,
                            dtype=dtype, generator=generator)

    def forward(self, node_x, edge_attr, face_node, face_mask):
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

    def forward(self, node_x, edge_attr, face_node, face_mask):
        n_nodes = node_x.shape[1]
        s, r = face_node[:, 0], face_node[:, 1]
        half_a, half_b = torch.chunk(edge_attr, 2, dim=-1)
        agg = (segment_sum(half_a, r, n_nodes, face_mask) +
               segment_sum(half_b, s, n_nodes, face_mask))      # [B, N, h/2]
        nbr_sum = _twoway_sum(gather_rows(agg, s), gather_rows(agg, r),
                              face_node, n_nodes, face_mask)
        ones = torch.ones(face_node.shape[:1] + face_node.shape[2:] + (1,),
                          dtype=node_x.dtype, device=node_x.device)
        deg = _twoway_sum(ones, ones, face_node, n_nodes, face_mask)
        nbr_avg = nbr_sum / torch.clamp(deg, min=1.0)
        return self.node_mlp(torch.cat([nbr_avg, node_x], dim=-1))


class GnBlock(nn.Module):
    """EdgeBlock → NodeBlock with residual connections on both streams."""

    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_block = EdgeBlock(hidden_size, dtype, generator)
        self.node_block = NodeBlock(hidden_size, dtype, generator)

    def forward(self, node_x, edge_attr, face_node, face_mask):
        edge_new = self.edge_block(node_x, edge_attr, face_node, face_mask)
        node_new = self.node_block(node_x, edge_new, face_node, face_mask)
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
