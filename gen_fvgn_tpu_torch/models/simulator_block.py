"""Block-engine simulators, with parameter trees identical to the JAX
package's `models/simulator_block.py` so converted checkpoints load key by
key. Ported: `FVGNSimulatorB`. The Transolver nets wait for a later slice."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.graph.packs import StaticPack
from gen_fvgn_tpu_torch.models.gn import Decoder, Encoder
from gen_fvgn_tpu_torch.models.gn_block import GnBlockB
from gen_fvgn_tpu_torch.utils.device import resolve_device


class FVGNSimulatorB(nn.Module):
    """Encoder → message_passing_num GraphNet blocks → Decoder.

    forward(node_feats [(B,) N, 12], edge_feats [(B,) E, 15], static)
    -> [(B,) N, 3]."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        dtype = torch.bfloat16 if c.mxu_dtype == "bfloat16" else None
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


def make_simulator_block(cfg: Config, device="cuda", seed: int = 0
                         ) -> nn.Module:
    """The block-engine simulator for cfg.net on `device`, weights drawn
    from torch.Generator().manual_seed(seed) (truncated normal 0.02, zero
    bias). device="cuda" without a card raises."""
    dev = resolve_device(device)
    if cfg.net == "FVGN":
        gen = torch.Generator().manual_seed(seed)
        return FVGNSimulatorB(cfg, generator=gen).to(dev)
    if cfg.net in ("TransFVGN_v1", "TransFVGN_v2", "TransFVGN"):
        raise NotImplementedError(
            f"net={cfg.net!r}: the Transolver nets (fused_premlp_res and "
            "fused_slice_pool kernels) belong to a later slice of the port; "
            "this slice ports net='FVGN'")
    raise ValueError(f"unknown net {cfg.net!r}")
