"""The operations and bytes of one step of the model's mathematics.

Counted from the configuration and the unpadded mesh, whatever engine or
kernel computes them: no padded row, no composed operator, no
recomputation. Each operation reads each of its inputs once and writes
each of its outputs once. The network streams bfloat16 (2 bytes, products
at the bf16 tensor-core peak); the finite-volume residual runs in float32
(4 bytes, the float32 peak). A training step adds the backward (twice the
forward's operations, and twice its bytes) and Adam.

Peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): 989 TFLOP/s bf16,
67 TFLOP/s float32 off the tensor cores, 3.35 TB/s HBM.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from benchmark.harness import spec

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float
    peak: float


def mlp_op(name, rows, k, h, out, in_bytes, batch, el=2):
    """A two-hidden-layer MLP over `rows` rows of `k` inputs: products
    2·rows·(k·h + h·h + h·out); reads `in_bytes` a sample and its weights,
    writes its output."""
    w = k * h + h * h + h * out
    return Op(name, batch * 2.0 * rows * w,
              batch * (in_bytes + rows * out * el) + el * w, PEAK_BF16)


def encoder_ops(cfg: Dict, mesh: Dict, batch: int) -> List[Op]:
    """The node encoder over the nodes, the edge encoder over the faces."""
    n, e = mesh["n_nodes"], mesh["n_faces"]
    h, k = cfg["hidden_size"], cfg["node_input_size"]
    return [mlp_op("node_encoder", n, k, h, h, n * k * 2, batch),
            mlp_op("edge_encoder", e, k + 3, h, h, e * (k + 3) * 2, batch)]


def decoder_op(cfg: Dict, mesh: Dict, batch: int) -> Op:
    n, h = mesh["n_nodes"], cfg["hidden_size"]
    return mlp_op("decoder", n, h, h, cfg["node_output_size"], n * h * 2,
                  batch)


def gn_ops(cfg: Dict, mesh: Dict, batch: int, tag: str) -> List[Op]:
    """A GraphNet block: the sums over each node's faces, the edge MLP, the
    NodeBlock's two half-width sums and the node MLP."""
    n, e = mesh["n_nodes"], mesh["n_faces"]
    h, b, el = cfg["hidden_size"], batch, 2
    return [
        Op(f"{tag}.edge_sum", b * 2.0 * e * h,
           b * 2 * n * h * el, PEAK_BF16),
        mlp_op(f"{tag}.edge_mlp", e, 3 * h, h, h,
               (n + e) * h * el, b),
        Op(f"{tag}.node_sums", b * 2.0 * e * h,
           b * (e * h + n * h // 2 + n * h // 2) * el, PEAK_BF16),
        mlp_op(f"{tag}.node_mlp", n, h + h // 2, h, h,
               n * (h + h // 2) * el, b)]


def transolver_ops(cfg: Dict, mesh: Dict, batch: int, tag: str) -> List[Op]:
    """A Transolver block: the physics attention and the pre-LayerNorm MLP
    of ratio 2."""
    n, h, b, el = mesh["n_nodes"], cfg["hidden_size"], batch, 2
    g = cfg["slice_num"]
    heads = cfg["attn_heads"]
    d = h // heads
    # in_project_fx and _x, slice logits, pooling and de-slice, to_out,
    # q/k/v of the tokens, the token attention
    attn = (2 * 2.0 * n * h * h + 2.0 * n * h * g
            + 2 * 2.0 * n * h * g + 2.0 * n * h * h
            + 3 * 2.0 * heads * g * d * d + 2 * 2.0 * heads * g * g * d)
    return [Op(f"{tag}.attention", b * attn,
               b * 2 * n * h * el + el * (4 * h * h), PEAK_BF16),
            Op(f"{tag}.mlp", b * 8.0 * n * h * h,
               b * 2 * n * h * el + el * 4 * h * h, PEAK_BF16)]


def fv_ops(mesh: Dict, batch: int) -> List[Op]:
    """The finite-volume residual, float32: WLSQ gradients, the node to
    cell and face interpolations, the fluxes, the cell to node average."""
    n, e, c = mesh["n_nodes"], mesh["n_faces"], mesh["n_cells"]
    s, m = mesh["n_slots"], mesh["n_stencil"]
    b, f4 = batch, 4
    return [
        Op("wlsq", b * 35.0 * m, b * (n * 7 + n * 14) * f4, PEAK_F32),
        Op("node_to_cell", b * 35.0 * s, b * (n * 21 + c * 7) * f4,
           PEAK_F32),
        Op("node_to_face", b * 70.0 * e, b * (n * 21 + e * 15) * f4,
           PEAK_F32),
        Op("fluxes", b * 30.0 * s, b * (e * 15 + c * 3) * f4, PEAK_F32),
        Op("cell_to_node", b * 10.0 * s, b * (c * 3 + n * 3) * f4,
           PEAK_F32),
    ]


def edge_features_op(cfg: Dict, mesh: Dict, batch: int) -> Op:
    """The edge features [x_s - x_r, pos_s - pos_r, |pos_s - pos_r|] over
    the faces, float32: put first in `forward_ops` by a net that reads
    them."""
    n, e, k = mesh["n_nodes"], mesh["n_faces"], cfg["node_input_size"]
    return Op("edge_features", batch * 16.0 * e,
              batch * (n * k * 4 + e * (k + 3) * 4), PEAK_F32)


def forward_ops(cfg: Dict, mesh: Dict, batch: int) -> List[Op]:
    """mesh: n_nodes, n_faces, n_cells, n_slots, n_stencil (two-way). The
    network's own operations (`forward_ops` of its file,
    `benchmark/reference/nets/<net>.py`, its input features among them),
    then the FV residual."""
    return (spec.net(cfg["net"]).forward_ops(cfg, mesh, batch)
            + fv_ops(mesh, batch))


def step_ops(cfg: Dict, mesh: Dict, batch: int, train: bool,
             n_params: int) -> List[Op]:
    fwd = forward_ops(cfg, mesh, batch)
    if not train:
        return fwd
    bwd = [Op(o.name + ".backward", 2 * o.flops, 2 * o.bytes, o.peak)
           for o in fwd]
    adam = Op("adam", 12.0 * n_params, 28.0 * n_params, PEAK_F32)
    return fwd + bwd + [adam]


def total_flops(ops: List[Op]) -> float:
    return sum(o.flops for o in ops)


def bound_seconds(ops: List[Op]) -> float:
    """The least time the chip could take: each operation at the larger
    of its operations over its peak and its bytes over the bandwidth."""
    return sum(max(o.flops / o.peak, o.bytes / HBM_BYTES_S) for o in ops)
