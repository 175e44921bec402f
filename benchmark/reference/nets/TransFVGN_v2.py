"""TransFVGN_v2, the reference's default net: Encoder -> two processors,
each `message_passing_num` GraphNet blocks then a Transolver block on
(their output + the processor's input) -> Decoder.

Source: github.com/Litianyu141/Gen-FVGN-steady,
`src/FVMmodel/Models/TransFVGN/TransFVGN_v2.py` (`AttnProcessor` :11-51,
`Simulator` :54-104), the GraphNet blocks of `Models/FVGN/EPD.py` and
`blocks.py`, the Transolver block of
`Models/GraphTransolver/GraphTransolver.py` (`Graph_Physics_Attention_1D`
:48-95, `Transolver_block` :131-169, on its call path without the
LayerNorm before the attention); arXiv 2405.04466. Departures: one graph
at a time, where upstream pools slices over a batch vector; GELU in its
tanh form and LayerNorm's eps 1e-6 are the system's; no `torch.compile`;
the weights are the benchmark's draw (`harness/weights.py`), not
upstream's initialisation.
"""

from benchmark.harness import flops, weights


def layout(cfg):
    h = cfg["hidden_size"]
    leaves = weights.encoder_leaves(cfg)
    for p in range(2):
        for i in range(cfg["message_passing_num"]):
            leaves += weights.gn_leaves(f"processor_{p}.gn_{i}", h)
        leaves += weights.transolver_leaves(f"processor_{p}.transolver", h,
                                            cfg["attn_heads"],
                                            cfg["slice_num"])
    return leaves + weights.decoder_leaves(cfg)


def forward(net, x, e, face_node, pos):
    """pos: unread; the edge features carry the faces' offsets."""
    s, r = face_node[0], face_node[1]
    x, e = net.encode(x, e)
    for p in range(2):
        x_in = x
        for i in range(net.cfg["message_passing_num"]):
            x, e = net.gn_block(x, e, s, r, f"processor_{p}.gn_{i}")
        x = net.transolver(net.s(x + x_in), f"processor_{p}.transolver")
    return net.decode(x)


def forward_ops(cfg, mesh, batch):
    ops = ([flops.edge_features_op(cfg, mesh, batch)]
           + flops.encoder_ops(cfg, mesh, batch))
    for p in range(2):
        for i in range(cfg["message_passing_num"]):
            ops += flops.gn_ops(cfg, mesh, batch, f"processor_{p}.gn_{i}")
        ops += flops.transolver_ops(cfg, mesh, batch,
                                    f"processor_{p}.transolver")
    return ops + [flops.decoder_op(cfg, mesh, batch)]
