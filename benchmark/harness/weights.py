"""The networks' parameters, by name and shape, drawn from the seed.

The names are the parameter tree that Gen-FVGN's networks share with the
system under test: MLPs `hidden_0`, `hidden_1`, `out` (kernels [in, out])
and `ln`; the Transolver block's attention projections, temperature,
pre-LayerNorm MLP. Every leaf is drawn in one call of a generator on the
device: kernels and biases N(0, 0.02²), LayerNorm scales 1 + N(0, 0.02²),
the slice temperatures 0.5 + N(0, 0.05²).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _mlp(name: str, k: int, h: int, out: int, ln: bool = True):
    leaves = [(f"{name}.hidden_0.kernel", (k, h)), (f"{name}.hidden_0.bias", (h,)),
              (f"{name}.hidden_1.kernel", (h, h)), (f"{name}.hidden_1.bias", (h,)),
              (f"{name}.out.kernel", (h, out)), (f"{name}.out.bias", (out,))]
    if ln:
        leaves += [(f"{name}.ln.scale", (out,)), (f"{name}.ln.bias", (out,))]
    return leaves


def _gn(name: str, h: int):
    return (_mlp(f"{name}.edge_block.edge_mlp", 3 * h, h, h)
            + _mlp(f"{name}.node_block.node_mlp", h // 2 + h, h, h))


def _transolver(name: str, h: int, heads: int, g: int):
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
    h, k = cfg["hidden_size"], cfg["node_input_size"]
    leaves = (_mlp("encoder.node_encoder", k, h, h)
              + _mlp("encoder.edge_encoder", k + 3, h, h))
    if cfg["net"] == "FVGN":
        for i in range(cfg["message_passing_num"]):
            leaves += _gn(f"gn_{i}", h)
    elif cfg["net"] == "TransFVGN_v2":
        for p in range(2):
            for i in range(cfg["message_passing_num"]):
                leaves += _gn(f"processor_{p}.gn_{i}", h)
            leaves += _transolver(f"processor_{p}.transolver", h,
                                  cfg["attn_heads"], cfg["slice_num"])
    else:
        raise ValueError(f"no parameter layout for net {cfg['net']!r}")
    return leaves + _mlp("decoder.node_decoder", h, h, cfg["node_output_size"],
                         ln=False)


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
