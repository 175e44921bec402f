"""Each network is a file of its own, `benchmark/reference/nets/<net>.py`,
that gives the harness its parameter layout, its reference forward and
its operations.

The two nets' numbers below were taken from the harness before it read
them from these files (where one `if cfg["net"] == ...` chain in each of
`weights.py`, `reference/model.py` and `flops.py` chose the net): the
layouts, the weights a seed draws, the step's operations and bytes, and
the reference's output, on the CPU. A toy net written into a directory of
its own shows that a net enters by its file alone; a second, which reads
the nodes' coordinates and no edges, writes Transolver's block (arXiv
2402.02366) from `Net`'s two halves."""

import hashlib
import json

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from benchmark.harness import flops, spec, weights
from benchmark.reference import mesh, physics, step
from benchmark.reference.model import Net

SEED = 2**31 + 5

# net: leaves, parameters, sha256 of "name:shape;..." (first 16 hex
# digits), sha256 of the drawn float32 weights in layout order
LAYOUTS = {"fvgn": (70, 525315, "f64f8e23cc7a1544", "0cf34dfb361376b8"),
           "transfvgn_v2": (154, 1181011, "af577af2d7ca255f",
                            "836547b424a3c00a")}

# (net, train): operations, FLOPs, bytes, bound seconds, sha256 of the
# operations' names joined by "," (4x4 cavity, batch 2)
STEP_OPS = {
    ("fvgn", False): (21, 68984200.0, 1555436, 4.643092537313433e-07,
                      "cfe6587f49271907"),
    ("fvgn", True): (43, 213256380.0, 19375128.0, 5.783620298507463e-06,
                     "5b8052acfb223fde"),
    ("transfvgn_v2", False): (37, 154697096.0, 3451628,
                              1.0303367164179105e-06, "a68faab9c0d825b8"),
    ("transfvgn_v2", True): (75, 478263420.0, 43423192.0,
                             1.2962146865671641e-05, "7c8378ec384b09bc"),
}

# (net, stream): the reference's output [25, 3] on the 4x4 cavity from
# inputs of seed 7: its sum, the sum of its magnitudes, its first row
OUTPUTS = {
    ("fvgn", None): (1.3275724709965289, 1.6081792651675642,
                     [-0.003859960939735174, 0.04805026203393936,
                      0.010174611583352089]),
    ("fvgn", "float8"): (1.3491968628950417, 1.6385464067570865,
                         [-0.0028626667335629463, 0.04932595044374466,
                          0.009689025580883026]),
    ("transfvgn_v2", None): (1.4230718035250902, 1.4230718035250902,
                             [0.020028740167617798, 0.027209967374801636,
                              0.012127364054322243]),
    ("transfvgn_v2", "float8"): (1.3514479082077742, 1.3514479082077742,
                                 [0.020887911319732666, 0.020887911319732666,
                                  0.011488351970911026]),
}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _cfg(name):
    path = spec.BENCH_DIR / "configs" / f"{name}.json"
    return json.loads(path.read_text())["config"]


def _mesh():
    st = mesh.statics(mesh.cavity(4))
    return st, {"n_nodes": st.n_nodes, "n_faces": st.face_node.shape[1],
                "n_cells": st.n_cells, "n_slots": st.slot_node.shape[0],
                "n_stencil": st.st_out.shape[0]}


def _inputs(cfg, st):
    """x, e, face_node and the mesh's coordinates, float32."""
    gen = torch.Generator().manual_seed(7)
    k = cfg["node_input_size"]
    return (torch.randn(st.n_nodes, k, generator=gen),
            torch.randn(st.face_node.shape[1], k + 3, generator=gen),
            torch.as_tensor(st.face_node),
            torch.as_tensor(st.pos, dtype=torch.float32))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_and_weights_are_the_parents(name):
    cfg = _cfg(name)
    lay = weights.layout(cfg)
    n, params, lay_sha, w_sha = LAYOUTS[name]
    assert len(lay) == n
    assert sum(torch.Size(s).numel() for _, s in lay) == params
    assert _sha(";".join(f"{k}:{tuple(s)}" for k, s in lay).encode()) \
        == lay_sha
    w = weights.draw(cfg, SEED, "cpu")
    flat = torch.cat([w[k].reshape(-1) for k, _ in lay])
    assert _sha(flat.numpy().tobytes()) == w_sha


@pytest.mark.parametrize("name,train", sorted(STEP_OPS))
def test_step_operations_are_the_parents(name, train):
    cfg = _cfg(name)
    _, m = _mesh()
    n_params = LAYOUTS[name][1]
    ops = flops.step_ops(cfg, m, 2, train, n_params)
    n, fl, by, bound, names = STEP_OPS[name, train]
    assert len(ops) == n
    assert flops.total_flops(ops) == fl
    assert sum(o.bytes for o in ops) == by
    assert flops.bound_seconds(ops) == pytest.approx(bound, rel=1e-12)
    assert _sha(",".join(o.name for o in ops).encode()) == names


@pytest.mark.parametrize("name,stream", sorted(OUTPUTS, key=str))
def test_reference_output_is_the_parents(name, stream):
    """The same arithmetic in the same order; float32 products on the CPU
    may add in another order with another count of threads."""
    cfg = _cfg(name)
    st, _ = _mesh()
    w = weights.draw(cfg, SEED, "cpu")
    with torch.no_grad():
        out = Net(w, cfg, stream)(*_inputs(cfg, st)).double()
    total, mag, first = OUTPUTS[name, stream]
    assert tuple(out.shape) == (25, 3)
    assert float(out.sum()) == pytest.approx(total, rel=1e-6)
    assert float(out.abs().sum()) == pytest.approx(mag, rel=1e-6)
    assert out[0].tolist() == pytest.approx(first, rel=1e-5, abs=1e-8)


TOY = '''"""A toy net: the encoders, one GraphNet block, the decoder."""

from benchmark.harness import flops, weights


def layout(cfg):
    return (weights.encoder_leaves(cfg)
            + weights.gn_leaves("toy_gn", cfg["hidden_size"])
            + weights.decoder_leaves(cfg))


def forward(net, x, e, face_node, pos):
    x, e = net.encode(x, e)
    x, e = net.gn_block(x, e, face_node[0], face_node[1], "toy_gn")
    return net.decode(x)


def forward_ops(cfg, mesh, batch):
    return ([flops.edge_features_op(cfg, mesh, batch)]
            + flops.encoder_ops(cfg, mesh, batch)
            + flops.gn_ops(cfg, mesh, batch, "toy_gn")
            + [flops.decoder_op(cfg, mesh, batch)])
'''


def test_a_new_net_enters_by_its_file_alone(tmp_path, monkeypatch):
    nets = tmp_path / "nets"
    nets.mkdir()
    (nets / "Toy.py").write_text(TOY)
    monkeypatch.setattr(spec, "NETS_DIR", nets)
    cfg = dict(_cfg("fvgn"), net="Toy")
    names = [k for k, _ in weights.layout(cfg)]
    assert names[16:32] == [k for k, _ in weights.gn_leaves("toy_gn", 128)]
    assert len(names) == 16 + 16 + 6

    w = weights.draw(cfg, SEED, "cpu")
    assert list(w) == names
    st, m = _mesh()
    x, e, fn, pos = _inputs(cfg, st)
    net = Net(w, cfg)
    with torch.no_grad():
        got = net(x, e, fn, pos)
        hx, he = net.encode(x, e)
        hx, _ = net.gn_block(hx, he, fn[0], fn[1], "toy_gn")
        assert torch.equal(got, net.decode(hx))

    ops = [o.name for o in flops.forward_ops(cfg, m, 2)]
    assert ops == (["edge_features", "node_encoder", "edge_encoder",
                    "toy_gn.edge_sum", "toy_gn.edge_mlp", "toy_gn.node_sums",
                    "toy_gn.node_mlp", "decoder"]
                   + [o.name for o in flops.fv_ops(m, 2)])


def test_an_unknown_net_names_the_file_to_add(tmp_path, monkeypatch):
    monkeypatch.setattr(spec, "NETS_DIR", tmp_path)
    cfg = dict(_cfg("fvgn"), net="Nowhere")
    want = str(tmp_path / "Nowhere.py")
    _, m = _mesh()
    for call in (lambda: weights.layout(cfg),
                 lambda: Net({}, cfg),
                 lambda: flops.forward_ops(cfg, m, 1)):
        with pytest.raises(ValueError, match="Nowhere") as err:
            call()
        assert want in str(err.value)


POS_TOY = '''"""A toy net that reads the nodes' coordinates and no edges: a lift
of [x, pos], one Transolver block with a LayerNorm before its attention,
and a head."""

import torch

from benchmark.harness import flops, weights


def layout(cfg):
    h, k, o = (cfg["hidden_size"], cfg["node_input_size"],
               cfg["node_output_size"])
    return ([("lift.kernel", (k + 2, h)), ("lift.bias", (h,)),
             ("blk.ln_1.scale", (h,)), ("blk.ln_1.bias", (h,))]
            + weights.transolver_leaves("blk", h, cfg["attn_heads"],
                                        cfg["slice_num"])
            + [("head.kernel", (h, o)), ("head.bias", (o,))])


def forward(net, x, e, face_node, pos):
    net.seen = (x, pos)
    h = net.dense(torch.cat([x, pos], -1), "lift")
    h = net.s(h + net.physics_attention(net.layer_norm(h, "blk.ln_1"),
                                        "blk"))
    return net.dense(net.premlp_res(h, "blk"), "head")


def forward_ops(cfg, mesh, batch):
    n, h, k, o = (mesh["n_nodes"], cfg["hidden_size"],
                  cfg["node_input_size"], cfg["node_output_size"])
    return ([flops.Op("lift", batch * 2.0 * n * (k + 2) * h,
                      batch * n * (k + 2 + h) * 2, flops.PEAK_BF16)]
            + flops.transolver_ops(cfg, mesh, batch, "blk")
            + [flops.Op("head", batch * 2.0 * n * h * o,
                        batch * n * (h + o) * 2, flops.PEAK_BF16)])
'''


@pytest.fixture
def pos_toy(tmp_path, monkeypatch):
    """The Config of the coordinates' toy, its file alone in `nets/`."""
    nets = tmp_path / "nets"
    nets.mkdir()
    (nets / "PosToy.py").write_text(POS_TOY)
    monkeypatch.setattr(spec, "NETS_DIR", nets)
    return dict(_cfg("transfvgn_v2"), net="PosToy")


def _attention_by_hand(p, x, name, heads):
    """Physics attention as Transolver's `Physics_Attention_Irregular_Mesh`
    writes it, in float32."""
    n, c = x.shape
    d = c // heads
    a = name + ".attn"

    def lin(v, leaf, bias=True):
        y = v @ p[f"{a}.{leaf}.kernel"]
        return y + p[f"{a}.{leaf}.bias"] if bias else y

    fx_mid = lin(x, "in_project_fx").reshape(n, heads, d)
    x_mid = lin(x, "in_project_x").reshape(n, heads, d)
    slice_weights = torch.softmax(
        lin(x_mid, "in_project_slice")
        / p[a + ".graph_temperature"].reshape(heads, 1), dim=-1)
    slice_norm = slice_weights.sum(0)
    slice_token = torch.einsum("nhg,nhd->hgd", slice_weights, fx_mid) \
        / (slice_norm[:, :, None] + 1e-5)
    q, k, v = (lin(slice_token, t, bias=False)
               for t in ("to_q", "to_k", "to_v"))
    attn = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1)
    out_x = torch.einsum("hgd,nhg->nhd", attn @ v, slice_weights)
    return lin(out_x.reshape(n, c), "to_out")


def _pre_ln_block_by_hand(p, x, name, heads):
    """Transolver's block: x + Attn(LN_1(x)), then + MLP(LN_2(x))."""
    def ln(v, leaf):
        return F.layer_norm(v, v.shape[-1:], p[f"{name}.{leaf}.scale"],
                            p[f"{name}.{leaf}.bias"], eps=1e-6)

    x = x + _attention_by_hand(p, ln(x, "ln_1"), name, heads)
    h = F.gelu(ln(x, "ln_2") @ p[name + ".mlp_pre.kernel"]
               + p[name + ".mlp_pre.bias"], approximate="tanh")
    return x + h @ p[name + ".mlp_post.kernel"] + p[name + ".mlp_post.bias"]


def test_a_net_that_reads_coordinates_enters_by_its_file_alone(pos_toy):
    cfg = pos_toy
    names = [k for k, _ in weights.layout(cfg)]
    assert names[:4] == ["lift.kernel", "lift.bias", "blk.ln_1.scale",
                         "blk.ln_1.bias"]
    assert names[4:-2] == [k for k, _ in weights.transolver_leaves(
        "blk", 128, 8, 32)]
    w = weights.draw(cfg, SEED, "cpu")
    assert list(w) == names

    st, m = _mesh()
    x, _, fn, pos = _inputs(cfg, st)
    with torch.no_grad():
        got = Net(w, cfg)(x, None, fn, pos)
        h = torch.cat([x, pos], -1) @ w["lift.kernel"] + w["lift.bias"]
        h = _pre_ln_block_by_hand(w, h, "blk", 8)
        want = h @ w["head.kernel"] + w["head.bias"]
    assert tuple(got.shape) == (25, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    ops = [o.name for o in flops.forward_ops(cfg, m, 2)]
    assert ops == (["lift", "blk.attention", "blk.mlp", "head"]
                   + [o.name for o in flops.fv_ops(m, 2)])
    step_ops = flops.step_ops(cfg, m, 2, True, len(names))
    assert not [o.name for o in step_ops if "edge_features" in o.name]


def test_the_step_hands_the_net_the_mesh_coordinates(pos_toy):
    """Through `step.forward`: the coordinates of a renumbered mesh, as
    the statics hold them, beside the node inputs of the same nodes."""
    raw = mesh.cavity(4)
    order = np.random.default_rng(3).permutation(raw.pos.shape[0])
    st = mesh.statics(raw.renumber(order))
    stt = step.statics_tensors(st, "cpu")
    env = step.env_tensors(physics.env_physics(
        dict(unsteady=1, continuity=1, convection=1, grad_p=1,
             sigma=[1, 1, 1]),
        dict(u=1.0, rho=1.0, mu=0.01, source=0.0, aoa=0.0, dt=0.05, L=1.0),
        st.node_type), "cpu")
    uvp = torch.cat([stt["pos"], stt["pos"].sum(-1, keepdim=True)], -1)
    net = Net(weights.draw(pos_toy, SEED, "cpu"), pos_toy)
    with torch.no_grad():
        step.forward(net, stt, uvp, env, torch.zeros(9), torch.ones(9))
    x, pos = net.seen
    assert pos.dtype == torch.float32 and tuple(pos.shape) == (25, 2)
    assert torch.equal(pos, stt["pos"])
    assert torch.equal(pos, torch.as_tensor(raw.pos[order],
                                            dtype=torch.float32))
    phi = (pos - pos.mean(0)) / (pos.std(0, unbiased=False) + 1e-8)
    torch.testing.assert_close(x[:, :2], phi, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["PosToy", "FVGN", "TransFVGN_v2"])
def test_shifting_the_coordinates_moves_only_a_net_that_reads_them(
        name, request):
    cfg = (request.getfixturevalue("pos_toy") if name == "PosToy"
           else _cfg(name.lower()))
    st, _ = _mesh()
    x, e, fn, pos = _inputs(cfg, st)
    net = Net(weights.draw(cfg, SEED, "cpu"), cfg)
    with torch.no_grad():
        a = net(x, e, fn, pos)
        b = net(x, e, fn, pos + torch.tensor([3.0, -2.0]))
    assert torch.equal(a, b) == (name != "PosToy")


@pytest.mark.parametrize("stream", [None, "float8"])
def test_transolver_is_its_two_halves(stream):
    """Gen-FVGN's block, `Net.transolver`, is the attention added to its
    input, then `premlp_res`: bit for bit, on both streams."""
    cfg = _cfg("transfvgn_v2")
    net = Net(weights.draw(cfg, SEED, "cpu"), cfg, stream)
    x = torch.randn(40, 128, generator=torch.Generator().manual_seed(2))
    name = "processor_1.transolver"
    with torch.no_grad():
        got = net.transolver(x, name)
        want = net.premlp_res(net.s(x + net.physics_attention(x, name)),
                              name)
    assert torch.equal(got, want)


def test_a_pre_ln_block_from_the_halves_is_one_by_hand():
    cfg = _cfg("transfvgn_v2")
    name = "processor_0.transolver"
    w = weights.draw(cfg, SEED, "cpu")
    gen = torch.Generator().manual_seed(4)
    w[name + ".ln_1.scale"] = 1.0 + 0.02 * torch.randn(128, generator=gen)
    w[name + ".ln_1.bias"] = 0.02 * torch.randn(128, generator=gen)
    x = torch.randn(40, 128, generator=gen)
    net = Net(w, cfg)
    with torch.no_grad():
        h = net.s(x + net.physics_attention(
            net.layer_norm(x, name + ".ln_1"), name))
        got = net.premlp_res(h, name)
        want = _pre_ln_block_by_hand(w, x, name, 8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
