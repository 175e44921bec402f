"""Encoder and Decoder of the GraphNet backbone.

Counterpart of `gen_fvgn_tpu/models/gn.py` (`Encoder`, `Decoder`); the
segment-engine blocks of that file belong to a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gen_fvgn_tpu_torch.models.mlp import Mlp


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
