"""Each network is a file of its own, `benchmark/reference/nets/<net>.py`,
that gives the harness its parameter layout, its reference forward and
its operations.

The two nets' numbers below were taken from the harness before it read
them from these files (where one `if cfg["net"] == ...` chain in each of
`weights.py`, `reference/model.py` and `flops.py` chose the net): the
layouts, the weights a seed draws, the step's operations and bytes, and
the reference's output, on the CPU. A toy net written into a directory of
its own shows that a net enters by its file alone."""

import hashlib
import json

import pytest
import torch

from benchmark.harness import flops, spec, weights
from benchmark.reference import mesh
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
    gen = torch.Generator().manual_seed(7)
    k = cfg["node_input_size"]
    return (torch.randn(st.n_nodes, k, generator=gen),
            torch.randn(st.face_node.shape[1], k + 3, generator=gen),
            torch.as_tensor(st.face_node))


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


def forward(net, x, e, face_node):
    x, e = net.encode(x, e)
    x, e = net.gn_block(x, e, face_node[0], face_node[1], "toy_gn")
    return net.decode(x)


def forward_ops(cfg, mesh, batch):
    return (flops.encoder_ops(cfg, mesh, batch)
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
    x, e, fn = _inputs(cfg, st)
    net = Net(w, cfg)
    with torch.no_grad():
        got = net(x, e, fn)
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
