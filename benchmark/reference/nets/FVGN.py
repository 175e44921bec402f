"""FVGN: Encoder -> `message_passing_num` GraphNet blocks -> Decoder.

Source: github.com/Litianyu141/Gen-FVGN-steady, `--net FVGN`:
`src/FVMmodel/Models/FVGN/EPD.py` (`EncoderProcesserDecoder` :222-270,
`Encoder`, `GnBlock`, `Decoder`) and `blocks.py` (`EdgeBlock`,
`NodeBlock`); arXiv 2405.04466. Departures: upstream's `--net FVGN` entry
(`GenFVGN.py`) does not run, so this is EPD.py's stack as the system
under test builds it; one graph at a time, where upstream batches graphs
by a batch vector; GELU in its tanh form and LayerNorm's eps 1e-6 are the
system's; the weights are the benchmark's draw (`harness/weights.py`),
not upstream's initialisation.
"""

from benchmark.harness import flops, weights


def layout(cfg):
    leaves = weights.encoder_leaves(cfg)
    for i in range(cfg["message_passing_num"]):
        leaves += weights.gn_leaves(f"gn_{i}", cfg["hidden_size"])
    return leaves + weights.decoder_leaves(cfg)


def forward(net, x, e, face_node, pos):
    """pos: unread; the edge features carry the faces' offsets."""
    s, r = face_node[0], face_node[1]
    x, e = net.encode(x, e)
    for i in range(net.cfg["message_passing_num"]):
        x, e = net.gn_block(x, e, s, r, f"gn_{i}")
    return net.decode(x)


def forward_ops(cfg, mesh, batch):
    ops = ([flops.edge_features_op(cfg, mesh, batch)]
           + flops.encoder_ops(cfg, mesh, batch))
    for i in range(cfg["message_passing_num"]):
        ops += flops.gn_ops(cfg, mesh, batch, f"gn_{i}")
    return ops + [flops.decoder_op(cfg, mesh, batch)]
