"""Segment-engine simulators: FVGN (pure GraphNet EPD) and TransFVGN v1/v2
(GraphNet + Transolver slice attention).

Counterpart of `gen_fvgn_tpu/models/simulator.py` (`AttnProcessor`,
`FVGNSimulator`, `TransFVGNv1`, `TransFVGNv2`, `make_simulator`), with the
parameter tree of the JAX nets, which is also that of the block-engine nets
(models/simulator_block.py): `convert.py::params_from_flax` loads a flax
tree into either, and a checkpoint of one engine serves the other. The
modules are built in the block nets' order, so `make_simulator` and
`make_simulator_block` draw the same weights from the same seed.

forward(node_feats [B, N, 12], edge_feats [B, E, 15], face_node [B, 2, E],
node_mask [B, N], face_mask [B, E]) -> [B, N, 3]: the batch is the leading
axis where the JAX nets see one graph under a vmap.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.config import Config
from gen_fvgn_tpu_torch.models.gn import Decoder, Encoder, GnBlock
from gen_fvgn_tpu_torch.models.transolver import TransolverBlock
from gen_fvgn_tpu_torch.utils.device import resolve_device


def _stream_dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.mxu_dtype == "bfloat16" else None


class _Blocks(nn.Module):
    """`n` GnBlocks named gn_0 .. gn_{n-1}, applied in turn."""

    def _add_blocks(self, n, hidden_size, dtype, generator):
        self.n_blocks = n
        for i in range(n):
            setattr(self, f"gn_{i}", GnBlock(hidden_size, dtype, generator))

    def _run_blocks(self, node_h, edge_h, face_node, face_mask):
        for i in range(self.n_blocks):
            node_h, edge_h = getattr(self, f"gn_{i}")(node_h, edge_h,
                                                     face_node, face_mask)
        return node_h, edge_h


class AttnProcessor(_Blocks):
    """message_passing_num GnBlocks, then one Transolver block on the
    blocks' output plus the processor's input."""

    def __init__(self, hidden_size: int, message_passing_num: int,
                 heads: int, slice_num: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._add_blocks(message_passing_num, hidden_size, dtype, generator)
        self.transolver = TransolverBlock(hidden_size, heads, slice_num,
                                          dtype=dtype, generator=generator)

    def forward(self, node_h, edge_h, face_node, node_mask, face_mask):
        node_in = node_h
        node_h, edge_h = self._run_blocks(node_h, edge_h, face_node,
                                          face_mask)
        return self.transolver(node_h + node_in, node_mask), edge_h


class FVGNSimulator(_Blocks):
    """Encoder → message_passing_num GnBlocks → Decoder."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        dtype = _stream_dtype(c)
        self.encoder = Encoder(c.node_input_size, c.edge_input_size,
                               c.hidden_size, dtype, generator)
        self._add_blocks(c.message_passing_num, c.hidden_size, dtype,
                         generator)
        self.decoder = Decoder(c.node_output_size, c.hidden_size, dtype,
                               generator)

    def forward(self, node_feats, edge_feats, face_node, node_mask,
                face_mask):
        node_h, edge_h = self.encoder(node_feats, edge_feats)
        node_h, _ = self._run_blocks(node_h, edge_h, face_node, face_mask)
        return self.decoder(node_h)


class TransFVGNv1(FVGNSimulator):
    """Encoder → N GnBlocks → one Transolver block → Decoder."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        self.transolver = TransolverBlock(
            cfg.hidden_size, cfg.attn_heads, cfg.slice_num,
            dtype=_stream_dtype(cfg), generator=generator)

    def forward(self, node_feats, edge_feats, face_node, node_mask,
                face_mask):
        node_h, edge_h = self.encoder(node_feats, edge_feats)
        node_h, _ = self._run_blocks(node_h, edge_h, face_node, face_mask)
        return self.decoder(self.transolver(node_h, node_mask))


class TransFVGNv2(nn.Module):
    """Encoder → 2 AttnProcessors → Decoder (the default backbone)."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        dtype = _stream_dtype(c)
        self.encoder = Encoder(c.node_input_size, c.edge_input_size,
                               c.hidden_size, dtype, generator)
        for i in range(2):
            setattr(self, f"processor_{i}", AttnProcessor(
                c.hidden_size, c.message_passing_num, c.attn_heads,
                c.slice_num, dtype, generator))
        self.decoder = Decoder(c.node_output_size, c.hidden_size, dtype,
                               generator)

    def forward(self, node_feats, edge_feats, face_node, node_mask,
                face_mask):
        node_h, edge_h = self.encoder(node_feats, edge_feats)
        for i in range(2):
            node_h, edge_h = getattr(self, f"processor_{i}")(
                node_h, edge_h, face_node, node_mask, face_mask)
        return self.decoder(node_h)


NETS = {"FVGN": FVGNSimulator, "TransFVGN_v1": TransFVGNv1,
        "TransFVGN_v2": TransFVGNv2, "TransFVGN": TransFVGNv2}


def make_simulator(cfg: Config, device="cuda", seed: int = 0) -> nn.Module:
    """The segment-engine simulator for cfg.net on `device`, weights drawn
    from torch.Generator().manual_seed(seed) as `make_simulator_block`
    draws them. device="cuda" without a card raises."""
    dev = resolve_device(device)
    if cfg.net not in NETS:
        raise ValueError(f"unknown net {cfg.net!r}")
    return NETS[cfg.net](cfg, generator=torch.Generator().manual_seed(seed)
                         ).to(dev)
