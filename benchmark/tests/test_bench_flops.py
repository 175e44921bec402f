"""The FLOP and byte counts at a tiny mesh against a count by hand."""

from benchmark.harness import flops
from benchmark.reference import mesh

CFG = {"net": "FVGN", "hidden_size": 128, "node_input_size": 12,
       "node_output_size": 3, "message_passing_num": 3, "attn_heads": 8,
       "slice_num": 32}


def two_by_two():
    st = mesh.statics(mesh.cavity(2))
    return {"n_nodes": st.n_nodes, "n_faces": st.face_node.shape[1],
            "n_cells": st.n_cells, "n_slots": st.slot_node.shape[0],
            "n_stencil": st.st_out.shape[0]}


def test_mesh_counts_of_two_by_two_squares():
    # 9 nodes, 12 faces, 4 cells of 4 corners; stencil: the 20 pairs that
    # share a cell (12 faces, 8 diagonals), then the 12 pairs one face
    # apart and the 14 two faces apart (8 diagonals, 6 straight): 46
    # one-way, 92 two-way
    assert two_by_two() == {"n_nodes": 9, "n_faces": 12, "n_cells": 4,
                            "n_slots": 16, "n_stencil": 92}


def test_fvgn_forward_by_hand():
    ops = flops.forward_ops(CFG, two_by_two(), batch=1)
    h = 128
    n, e, s, m = 9, 12, 16, 92
    enc = 2 * n * (12 * h + 2 * h * h) + 2 * e * (15 * h + 2 * h * h)
    gn = (2 * e * h                              # edge sums: 2 a face
          + 2 * e * (3 * h * h + 2 * h * h)      # edge MLP
          + 2 * e * h                            # node sums
          + 2 * n * (192 * h + 2 * h * h))       # node MLP
    dec = 2 * n * (h * h + h * h + h * 3)
    fv = 16 * e + 35 * m + 35 * s + 70 * e + 30 * s + 10 * s
    assert flops.total_flops(ops) == enc + 3 * gn + dec + fv


def test_training_adds_backward_and_adam():
    ops = flops.step_ops(CFG, two_by_two(), 2, True, n_params=1000)
    fwd = flops.total_flops(flops.forward_ops(CFG, two_by_two(), 2))
    assert flops.total_flops(ops) == 3 * fwd + 12 * 1000


def test_bytes_and_bound_by_hand():
    ops = {o.name: o for o in flops.forward_ops(CFG, two_by_two(), batch=2)}
    h = 128
    # decoder: reads 9 rows of h bf16 a sample, writes 9 rows of 3, and
    # its weights once
    assert ops["decoder"].bytes == 2 * (9 * h * 2 + 9 * 3 * 2) \
        + 2 * (h * h + h * h + h * 3)
    o = ops["decoder"]
    assert flops.bound_seconds([o]) == max(o.flops / 989e12,
                                           o.bytes / 3.35e12)
