"""GraphNet blocks on the sparse-operator engine.

Counterpart of `gen_fvgn_tpu/models/gn_block.py`, with the same parameter
tree. All sparse transfers are precomputed LinOps (ops/blocksparse.py);
tensors are batch-major [B, N, C] / [B, E, C] (or unbatched [N, C]).

Ported branches: the EdgeBlock's take path (two `Gathered` projections of
the neighbour sum) and its paired-gather form (`GatheredPair`, one pass of
the pair-sum kernel K8), and the NodeBlock's "composed" aggregation, as two
applies or in its paired form (`apply_node_pair`: K8 forward, K9 backward).
The JAX package picks the paired forms by the process-wide switches
`use_gather_pair()` / `use_node_pair()`, both off by default; here they are
the constructor arguments `gather_pair` / `node_pair` of the same names,
also off by default. The parameter tree is the same either way. The JAX
package falls back to the two-apply forms where its pair window does not
build (a band too wide for the TPU tiles); CSR has no such limit, so here
the argument alone decides. The "split"/"wide" aggregations and the
composed-gather EdgeBlock form belong to a later slice and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.graph.packs import StaticPack
from gen_fvgn_tpu_torch.models.mlp import Gathered, GatheredPair, Mlp
from gen_fvgn_tpu_torch.ops.blocksparse import (apply_linop, apply_node_agg,
                                               apply_node_pair)


class EdgeBlockB(nn.Module):
    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 gather_pair: bool = False):
        super().__init__()
        # JAX's conditions: the switch, a bf16 stream and the fused
        # LayerNorm chain (which the Mlp itself checks: outside it a
        # GatheredPair is materialized as the two gathers)
        self.gather_pair = gather_pair and dtype == torch.bfloat16
        # parts (agg@sender, agg@receiver, edge_attr), or (the pair of
        # them, edge_attr); residual_dual: the epilogue emits BOTH the raw
        # edge update (consumed by the NodeBlock) and edge_attr + update
        # (the residual stream)
        self.edge_mlp = Mlp(3 * hidden_size, hidden_size, hidden_size,
                            dtype=dtype,
                            residual_part=1 if self.gather_pair else 2,
                            residual_dual=True, generator=generator)

    def forward(self, node_x, edge_attr, static: StaticPack):
        ops = static.ops
        agg = apply_linop(ops.adj, node_x)               # neighbour sum
        # Gathered parts: the MLP projects agg by the sender/receiver W1
        # row-slices on the NODE side and row-gathers the projections —
        # the same math as gathering first
        if self.gather_pair:
            gathered = (GatheredPair(agg, ops),)
        else:
            gathered = (Gathered(agg, ops.gather_s),
                        Gathered(agg, ops.gather_r))
        return self.edge_mlp(gathered + (edge_attr,))


class NodeBlockB(nn.Module):
    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 node_agg: str = "composed",
                 generator: Optional[torch.Generator] = None,
                 node_pair: bool = False):
        super().__init__()
        if node_agg != "composed":
            raise NotImplementedError(
                f"node_agg={node_agg!r}: only the 'composed' NodeBlock "
                "aggregation is ported; 'split' and 'wide' belong to a later "
                "slice of the port")
        self.hidden_size = hidden_size
        # in any dtype, as JAX's node_pair_enabled()
        self.node_pair = node_pair
        # parts (nbr_avg [h/2], node_x [h]); residual folded into the MLP epilogue
        self.node_mlp = Mlp(hidden_size // 2 + hidden_size, hidden_size,
                            hidden_size,
                            dtype=dtype, residual_part=1, generator=generator)

    def forward(self, node_x, edge_attr, static: StaticPack):
        ops = static.ops
        if ops.nbr_r is None:
            raise ValueError("the StaticPack was built without the composed "
                             "nbr_r/nbr_s operators (node_agg='composed')")
        if self.node_pair:
            # nbr_r·e[..., :h2] + nbr_s·e[..., h2:] in ONE pass (K8), and
            # ONE dual-output transpose pass (K9) in the backward
            nbr_sum = apply_node_pair(ops, edge_attr)
        else:
            # nbr_r·e[..., :h2] + nbr_s·e[..., h2:] with the precomputed
            # adj@scat operators, each on its kept column window (the
            # JAX package applies both to all h columns and then keeps a
            # half of each: the same bits)
            nbr_sum = apply_node_agg(ops, edge_attr)     # [.., N, h2]
        # keep the bf16 stream bf16: inv_deg is cast to the stream type and
        # multiplied there
        inv_deg = (1.0 / torch.clamp(ops.deg, min=1.0)).to(nbr_sum.dtype)
        nbr_avg = nbr_sum * inv_deg
        return self.node_mlp((nbr_avg, node_x))


class GnBlockB(nn.Module):
    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 node_agg: str = "composed",
                 generator: Optional[torch.Generator] = None,
                 gather_pair: bool = False, node_pair: bool = False):
        super().__init__()
        self.edge_block = EdgeBlockB(hidden_size, dtype, generator,
                                     gather_pair)
        self.node_block = NodeBlockB(hidden_size, dtype, node_agg, generator,
                                     node_pair)

    def forward(self, node_x, edge_attr, static: StaticPack):
        edge_new, edge_stream = self.edge_block(node_x, edge_attr, static)
        node_stream = self.node_block(node_x, edge_new, static)
        return node_stream, edge_stream
