"""The networks' parameters, by name and shape, drawn from the seed.

The names are the parameter tree that Gen-FVGN's networks share with the
system under test: MLPs `hidden_0`, `hidden_1`, `out` (kernels [in, out])
and `ln`; the Transolver block's attention projections, temperature,
pre-LayerNorm MLP. Each network's file (`benchmark/reference/nets/`)
lists its leaves from the pieces below. Every leaf is drawn in one call of
a generator on the device: kernels and biases N(0, 0.02²), LayerNorm
scales 1 + N(0, 0.02²), the slice temperatures 0.5 + N(0, 0.05²).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.harness import spec


def mlp_leaves(name: str, k: int, h: int, out: int, ln: bool = True):
    """A two-hidden-layer MLP from `k` to `out` through `h`, with a
    trailing LayerNorm where `ln`."""
    leaves = [(f"{name}.hidden_0.kernel", (k, h)), (f"{name}.hidden_0.bias", (h,)),
              (f"{name}.hidden_1.kernel", (h, h)), (f"{name}.hidden_1.bias", (h,)),
              (f"{name}.out.kernel", (h, out)), (f"{name}.out.bias", (out,))]
    if ln:
        leaves += [(f"{name}.ln.scale", (out,)), (f"{name}.ln.bias", (out,))]
    return leaves


def encoder_leaves(cfg: Dict):
    """The node and edge encoders (the edge's inputs: the nodes' difference
    and the face's offset and length)."""
    h, k = cfg["hidden_size"], cfg["node_input_size"]
    return (mlp_leaves("encoder.node_encoder", k, h, h)
            + mlp_leaves("encoder.edge_encoder", k + 3, h, h))


def decoder_leaves(cfg: Dict):
    h = cfg["hidden_size"]
    return mlp_leaves("decoder.node_decoder", h, h, cfg["node_output_size"],
                      ln=False)


def gn_leaves(name: str, h: int):
    """A GraphNet block: the EdgeBlock's and the NodeBlock's MLPs."""
    return (mlp_leaves(f"{name}.edge_block.edge_mlp", 3 * h, h, h)
            + mlp_leaves(f"{name}.node_block.node_mlp", h // 2 + h, h, h))


def transolver_leaves(name: str, h: int, heads: int, g: int):
    """A Transolver block: physics attention over `g` slices in `heads`
    heads, then a pre-LayerNorm MLP of ratio 2."""
    d = h // heads
    a = f"{name}.attn"
    return [(f"{a}.graph_temperature", (1, heads, 1)),
            (f"{a}.in_project_fx.kernel", (h, h)), (f"{a}.in_project_fx.bias", (h,)),
            (f"{a}.in_project_x.kernel", (h, h)), (f"{a}.in_project_x.bias", (h,)),
            (f"{a}.in_project_slice.kernel", (d, g)),
            (f"{a}.in_project_slice.bias", (g,)),
            (f"{a}.to_q.kernel", (d, d)), (f"{a}.to_k.kernel", (d, d)),
            (f"{a}.to_v.kernel", (d, d)),
            (f"{a}.to_out.kernel", (h, h)), (f"{a}.to_out.bias", (h,)),
            (f"{name}.ln_2.scale", (h,)), (f"{name}.ln_2.bias", (h,)),
            (f"{name}.mlp_pre.kernel", (h, 2 * h)), (f"{name}.mlp_pre.bias", (2 * h,)),
            (f"{name}.mlp_post.kernel", (2 * h, h)), (f"{name}.mlp_post.bias", (h,))]


def layout(cfg: Dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every leaf in draw order: the `layout` of the net's
    file, `benchmark/reference/nets/<net>.py`."""
    return spec.net(cfg["net"]).layout(cfg)


def draw(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of `layout(cfg)` from one normal draw on `device`."""
    leaves = layout(cfg)
    sizes = [int(torch.Size(s).numel()) for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(leaves, torch.split(flat, sizes)):
        if name.endswith("graph_temperature"):
            v = 0.5 + 0.05 * part
        elif name.endswith(".scale"):
            v = 1.0 + 0.02 * part
        else:
            v = 0.02 * part
        out[name] = v.reshape(shape)
    return out
