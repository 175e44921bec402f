"""Block-engine simulators (FVGN / TransFVGN v1 / v2), with parameter trees
identical to the JAX package's `models/simulator_block.py` so converted
checkpoints load key by key."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import StaticPack
from gen_fvgn_tpu_torch.models.gn import Decoder, Encoder
from gen_fvgn_tpu_torch.models.gn_block import GnBlockB
from gen_fvgn_tpu_torch.models.transolver import TransolverBlock
from gen_fvgn_tpu_torch.utils.device import resolve_device


def _stream_dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.mxu_dtype == "bfloat16" else None


class AttnProcessorB(nn.Module):
    """message_passing_num GraphNet blocks, then a Transolver block on the
    blocks' output plus the processor's input."""

    def __init__(self, hidden_size: int, message_passing_num: int,
                 heads: int, slice_num: int,
                 dtype: Optional[torch.dtype] = None,
                 node_agg: str = "composed",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_blocks = message_passing_num
        for i in range(message_passing_num):
            setattr(self, f"gn_{i}",
                    GnBlockB(hidden_size, dtype, node_agg, generator))
        self.transolver = TransolverBlock(hidden_size, heads, slice_num,
                                          dtype=dtype, generator=generator)

    def forward(self, node_h, edge_h, static: StaticPack):
        node_in = node_h
        for i in range(self.n_blocks):
            node_h, edge_h = getattr(self, f"gn_{i}")(node_h, edge_h, static)
        node_h = self.transolver(node_h + node_in, static.node_mask)
        return node_h, edge_h


class FVGNSimulatorB(nn.Module):
    """Encoder → message_passing_num GraphNet blocks → Decoder.

    forward(node_feats [(B,) N, 12], edge_feats [(B,) E, 15], static)
    -> [(B,) N, 3]."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        dtype = _stream_dtype(c)
        self.encoder = Encoder(c.node_input_size, c.edge_input_size,
                               c.hidden_size, dtype, generator)
        self.n_blocks = c.message_passing_num
        for i in range(c.message_passing_num):
            setattr(self, f"gn_{i}",
                    GnBlockB(c.hidden_size, dtype, c.node_agg, generator))
        self.decoder = Decoder(c.node_output_size, c.hidden_size, dtype,
                               generator)

    def forward(self, node_feats, edge_feats, static: StaticPack):
        node_h, edge_h = self.encoder(node_feats, edge_feats)
        for i in range(self.n_blocks):
            node_h, edge_h = getattr(self, f"gn_{i}")(node_h, edge_h, static)
        return self.decoder(node_h)


class TransFVGNv1B(FVGNSimulatorB):
    """FVGNSimulatorB with a Transolver block between the GraphNet blocks
    and the Decoder."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        self.transolver = TransolverBlock(
            cfg.hidden_size, cfg.attn_heads, cfg.slice_num,
            dtype=_stream_dtype(cfg), generator=generator)

    def forward(self, node_feats, edge_feats, static: StaticPack):
        node_h, edge_h = self.encoder(node_feats, edge_feats)
        for i in range(self.n_blocks):
            node_h, edge_h = getattr(self, f"gn_{i}")(node_h, edge_h, static)
        return self.decoder(self.transolver(node_h, static.node_mask))


class TransFVGNv2B(nn.Module):
    """Encoder → 2 AttnProcessorB (message_passing_num GraphNet blocks and
    a Transolver block each) → Decoder."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        dtype = _stream_dtype(c)
        self.encoder = Encoder(c.node_input_size, c.edge_input_size,
                               c.hidden_size, dtype, generator)
        for i in range(2):
            setattr(self, f"processor_{i}", AttnProcessorB(
                c.hidden_size, c.message_passing_num, c.attn_heads,
                c.slice_num, dtype, c.node_agg, generator))
        self.decoder = Decoder(c.node_output_size, c.hidden_size, dtype,
                               generator)

    def forward(self, node_feats, edge_feats, static: StaticPack):
        node_h, edge_h = self.encoder(node_feats, edge_feats)
        for i in range(2):
            node_h, edge_h = getattr(self, f"processor_{i}")(node_h, edge_h,
                                                             static)
        return self.decoder(node_h)


NETS = {"FVGN": FVGNSimulatorB, "TransFVGN_v1": TransFVGNv1B,
        "TransFVGN_v2": TransFVGNv2B, "TransFVGN": TransFVGNv2B}


def make_simulator_block(cfg: Config, device="cuda", seed: int = 0
                         ) -> nn.Module:
    """The block-engine simulator for cfg.net on `device`, weights drawn
    from torch.Generator().manual_seed(seed) (truncated normal 0.02, zero
    bias, orthogonal slice kernels, temperature 0.5). device="cuda" without
    a card raises."""
    dev = resolve_device(device)
    if cfg.net not in NETS:
        raise ValueError(f"unknown net {cfg.net!r}")
    gen = torch.Generator().manual_seed(seed)
    return NETS[cfg.net](cfg, generator=gen).to(dev)
