"""GraphNet blocks on the sparse-operator engine.

Counterpart of `gen_fvgn_tpu/models/gn_block.py`, with the same parameter
tree. All sparse transfers are precomputed LinOps (ops/blocksparse.py);
tensors are batch-major [B, N, C] / [B, E, C] (or unbatched [N, C]).

The EdgeBlock's gathered projections take one of three forms: the take
path (two `Gathered` row-gathers of the projected neighbour sum), the
paired gather (`GatheredPair`, one pass of the pair-sum kernel K8), or the
composed gathers (two `Gathered` parts on gsadj = Gs@adj and gradj =
Gr@adj: E←N applies of the projected node stream, K1 at width 128, whose
padded edge rows come out zero). The NodeBlock aggregates by `node_agg`:
"composed" (the adj@scat operators, as two windowed applies or in its
paired form `apply_node_pair`: K8 forward, K9 backward), "wide" (two
scatters on column windows, then adj) or "split" (two half-width
scatters, then adj); all three give the same sums.

The JAX package picks the paired forms and the composed gathers by the
process-wide switches `use_gather_pair()`, `use_node_pair()` and
`use_composed_gather()`, all off by default; here they are the constructor
arguments `gather_pair`, `node_pair` and `composed_gather`, also off by
default (the nets set `composed_gather` from cfg.edge_gather). The
parameter tree is the same either way. Under spatial parallelism
(`parallel/sp.py`) both paired forms give way to their two-apply forms
(JAX's `node_pair_enabled()` is False under an sp mesh), whose applies
run on the rank's rows. Where the JAX package meets a pack
without the operators a form needs, it takes another form; here asking
for a form whose operators the pack lacks raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.graph.packs import StaticPack
from gen_fvgn_tpu_torch.models.mlp import Gathered, GatheredPair, Mlp
from gen_fvgn_tpu_torch.ops.blocksparse import (apply_half_agg, apply_linop,
                                                apply_node_agg,
                                                apply_node_pair, sp_layout)

NODE_AGGS = ("composed", "wide", "split")


class EdgeBlockB(nn.Module):
    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 gather_pair: bool = False, composed_gather: bool = False):
        super().__init__()
        if gather_pair and composed_gather:
            raise ValueError("gather_pair and composed_gather are two forms "
                             "of the same gathers; ask for one")
        self.composed_gather = composed_gather
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
        if self.composed_gather:
            if ops.gsadj is None:
                raise ValueError("composed_gather: the StaticPack was built "
                                 "without the gsadj/gradj operators "
                                 "(edge_gather='composed')")
            # the MLP projects node_x by the sender/receiver W1 row-slices
            # at node cardinality, then applies gsadj / gradj (E←N) to the
            # projections: take_side(adj@x · W) == (G_side@adj) @ (x·W)
            gathered = (Gathered(node_x, ops.gsadj),
                        Gathered(node_x, ops.gradj))
            return self.edge_mlp(gathered + (edge_attr,))
        agg = apply_linop(ops.adj, node_x)               # neighbour sum
        # Gathered parts: the MLP projects agg by the sender/receiver W1
        # row-slices on the NODE side and row-gathers the projections —
        # the same math as gathering first
        if self.gather_pair and sp_layout() is None:
            # (under sp the two gathers: K8 is a single-device pass)
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
        if node_agg not in NODE_AGGS:
            raise ValueError(f"node_agg must be one of {NODE_AGGS}, got "
                             f"{node_agg!r}")
        if node_pair and node_agg != "composed":
            raise ValueError("node_pair is a form of the 'composed' "
                             f"aggregation, not of {node_agg!r}")
        self.hidden_size = hidden_size
        self.node_agg = node_agg
        # in any dtype, as JAX's node_pair_enabled()
        self.node_pair = node_pair
        # parts (nbr_avg [h/2], node_x [h]); residual folded into the MLP epilogue
        self.node_mlp = Mlp(hidden_size // 2 + hidden_size, hidden_size,
                            hidden_size,
                            dtype=dtype, residual_part=1, generator=generator)

    def forward(self, node_x, edge_attr, static: StaticPack):
        ops = static.ops
        h2 = self.hidden_size // 2
        if self.node_agg == "composed":
            if ops.nbr_r is None:
                raise ValueError("the StaticPack was built without the "
                                 "composed nbr_r/nbr_s operators "
                                 "(node_agg='composed')")
            if self.node_pair and sp_layout() is None:
                # nbr_r·e[..., :h2] + nbr_s·e[..., h2:] in ONE pass (K8),
                # and ONE dual-output transpose pass (K9) in the backward;
                # under sp the two windowed applies, as JAX's
                # node_pair_enabled() falls back
                nbr_sum = apply_node_pair(ops, edge_attr)
            else:
                # the precomputed adj@scat operators, each on its kept
                # column window (the JAX package applies both to all h
                # columns and then keeps a half of each: the same bits)
                nbr_sum = apply_node_agg(ops, edge_attr)     # [.., N, h2]
        elif self.node_agg == "wide":
            # JAX: t = scat_r·e, u = scat_s·e at full width, then
            # t[..., :h2] + u[..., h2:]; the same bits on the kept windows
            agg = apply_half_agg(ops.scat_r, ops.scat_s, edge_attr)
            nbr_sum = apply_linop(ops.adj, agg)
        else:
            # "split": the two halves of the edge stream scattered apart
            # (width h2), summed, then the neighbour sum
            agg = apply_linop(ops.scat_r, edge_attr[..., :h2]) + \
                apply_linop(ops.scat_s, edge_attr[..., h2:])
            nbr_sum = apply_linop(ops.adj, agg)
        # keep the bf16 stream bf16: inv_deg is cast to the stream type and
        # multiplied there
        inv_deg = (1.0 / torch.clamp(ops.deg, min=1.0)).to(nbr_sum.dtype)
        nbr_avg = nbr_sum * inv_deg
        return self.node_mlp((nbr_avg, node_x))


class GnBlockB(nn.Module):
    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 node_agg: str = "composed",
                 generator: Optional[torch.Generator] = None,
                 gather_pair: bool = False, node_pair: bool = False,
                 composed_gather: bool = False):
        super().__init__()
        self.edge_block = EdgeBlockB(hidden_size, dtype, generator,
                                     gather_pair, composed_gather)
        self.node_block = NodeBlockB(hidden_size, dtype, node_agg, generator,
                                     node_pair)

    def forward(self, node_x, edge_attr, static: StaticPack):
        edge_new, edge_stream = self.edge_block(node_x, edge_attr, static)
        node_stream = self.node_block(node_x, edge_new, static)
        return node_stream, edge_stream
