"""PyTorch port, the case files: the COMSOL and Tecplot readers, the .h5
files, `load_case`, the boundary zone, the conversion CLI and the writers
(.vtu / .vtp, TensorBoard events) against the JAX package's, on the same
files.

Files: cavities of 7x7 nodes or fewer written by
`gen_fvgn_tpu_torch/tools/case_files.py` (quadrilaterals, triangles, both
mixed; the lid-driven and the channel layouts, with and without a pressure
point) and a pipe-flow channel with a square obstacle as a Tecplot `.dat`
in the reference's zone layout. Measured deviations (the limits in
brackets): every array the readers, the compiler and the converter give
equal to the bit (integer arrays exact, float arrays 1e-6); in
`load_case`, the WLSQ moments' column scale within 1.6e-7 of its scale
(1e-6) and the folded WLSQ solve matrix `wlsq_S` within 3.9e-6 of its
scale (1e-5: the moments are float32 sums taken in another order than
XLA's, held to 1e-5 in tests/test_torch_operators.py, and wlsq_S inverts
them); the writers' files byte for byte.
"""

import os
import shutil
import socket
import time

import numpy as np
import pytest
from torch_port_common import pin_jax_block_forms  # noqa: F401 (autouse)

KINDS = [("quad", "lid", None), ("tri", "channel", None),
         ("mixed", "lid", 1)]


def _cavity(root, kind, boundary, press, n=6):
    from gen_fvgn_tpu_torch.tools.case_files import write_cavity_case
    return write_cavity_case(os.path.join(str(root), f"cavity_{kind}"), n=n,
                             kind=kind, boundary=boundary,
                             pressure_point=press)


def _cylinder(root):
    from gen_fvgn_tpu_torch.tools.case_files import write_cylinder_case
    return write_cylinder_case(os.path.join(str(root), "cylinder_pipe"))


def _assert_same(got, ref, where, float_tol=1e-6, tols=None):
    """Two dicts of arrays: the same keys, integer arrays exact, float
    arrays within `float_tol` of their scale (or tols[key])."""
    assert set(got) == set(ref), (where, set(got) ^ set(ref))
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (where, k)
        if np.issubdtype(b.dtype, np.floating):
            tol = (tols or {}).get(k, float_tol)
            scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-30)
            assert np.abs(a - b).max(initial=0) <= tol * scale, (where, k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("kind,boundary,press", KINDS,
                         ids=[k for k, _, _ in KINDS])
def test_comsol_reader_matches_jax(tmp_path, kind, boundary, press):
    from gen_fvgn_tpu.meshes import comsol as jc
    from gen_fvgn_tpu_torch.meshes import comsol as tc
    from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
    from gen_fvgn_tpu_torch.utils.types import NodeType
    path = os.path.join(_cavity(tmp_path, kind, boundary, press),
                        "mesh.mphtxt")
    tp, jp = tc.parse_mphtxt(path), jc.parse_mphtxt(path)
    assert set(tp) == set(jp) == {"vertices", "vtx", "edg"} | (
        {"tri", "quad"} if kind == "mixed" else {kind})
    for name in jp:
        _assert_same(tp[name] if name != "vertices" else {"v": tp[name]},
                     jp[name] if name != "vertices" else {"v": jp[name]},
                     name, float_tol=0.0)
    raw = tc.comsol_to_mesh(path)
    _assert_same(raw, jc.comsol_to_mesh(path), "comsol_to_mesh", 0.0)
    nt = raw["node|node_type"]
    assert (nt == NodeType.IN_WALL).sum() == 2
    assert ((nt == NodeType.OUTFLOW).sum() > 0) == (boundary == "channel")
    assert (nt == NodeType.PRESS_POINT).sum() == (press is not None)
    mesh = compile_mesh(raw)
    assert np.isclose(mesh["cell|cells_area"].sum(), 1.0)


def test_comsol_quad_cavity_is_the_synthetic_cavity(tmp_path):
    """The lid-driven quad cavity read from its file is, array for array,
    `meshes/synthetic.py::cavity_quad_mesh`, the main path's mesh."""
    from gen_fvgn_tpu_torch.meshes.comsol import comsol_to_mesh
    from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
    from gen_fvgn_tpu_torch.meshes.synthetic import cavity_quad_mesh
    path = os.path.join(_cavity(tmp_path, "quad", "lid", None), "mesh.mphtxt")
    _assert_same(compile_mesh(comsol_to_mesh(path)), cavity_quad_mesh(6),
                 "quad cavity", 0.0)


def test_geo_id_ranges_and_corner_priority_match_jax():
    """BC.json geo-id lists with "a-b" ranges and nesting, and the corner
    priority inflow -> wall -> outflow -> pressure point."""
    from gen_fvgn_tpu.meshes import comsol as jc
    from gen_fvgn_tpu_torch.meshes import comsol as tc
    raw = [1, "3-5", [7, ["9-10"]], "12"]
    assert tc._expand_geo_ids(raw) == jc._expand_geo_ids(raw) == \
        [1, 3, 4, 5, 7, 9, 10, 12]
    assert tc._expand_geo_ids(None) is None
    # a square of four edges (geo 1-4) and its four corners (geo 1-4)
    mesh_file = {
        "vertices": np.zeros((8, 2)),
        "edg": {"elements": np.asarray([[0, 1], [1, 2], [2, 3], [3, 0],
                                        [0, 4], [4, 1]]),
                "geo": np.asarray([1, 2, 3, 4, 1, 1])},
        "vtx": {"elements": np.asarray([[0], [1], [2], [3]]),
                "geo": np.asarray([1, 2, 3, 4])}}
    for bc in ({"inflow": [1], "wall": [2, 4], "outflow": [3]},
               {"inflow": ["1-2"], "wall": [3], "pressure_point": [4],
                "surf": [3]},
               {"wall": [1, 2, 3, 4], "outflow": [2]}):
        tt, ts = tc.assign_node_types(mesh_file, bc)
        jt, js = jc.assign_node_types(mesh_file, bc)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(ts, js)


def test_tecplot_reader_matches_jax(tmp_path):
    from gen_fvgn_tpu.meshes import tecplot as jt
    from gen_fvgn_tpu_torch.meshes import tecplot as tt
    from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
    from gen_fvgn_tpu_torch.utils.types import NodeType
    d = _cylinder(tmp_path)
    path = os.path.join(d, "mesh.dat")
    _assert_same(tt.parse_tecplot_dat(path), jt.parse_tecplot_dat(path),
                 "parse_tecplot_dat", 0.0)
    raw = tt.tecplot_to_mesh(path, "cylinder_pipe")
    _assert_same(raw, jt.tecplot_to_mesh(path, "cylinder_pipe"),
                 "tecplot_to_mesh", 0.0)
    nt = raw["node|node_type"]
    assert {int(t) for t in np.unique(nt)} == {
        NodeType.NORMAL, NodeType.INFLOW, NodeType.OUTFLOW,
        NodeType.WALL_BOUNDARY}
    assert raw["node|surf_mask"].sum() == 10        # the obstacle's ring
    mesh = compile_mesh(raw)
    assert np.isclose(mesh["cell|cells_area"].sum(),
                      2.2 * 0.41 * (1 - 6 / (22 * 8)))
    with pytest.raises(ValueError, match="cylinder"):
        tt.tecplot_to_mesh(path, "channel")


@pytest.mark.parametrize("case", ["quad", "tri", "mixed", "cylinder"])
def test_load_case_matches_jax(tmp_path, case):
    from gen_fvgn_tpu.training.pool import load_case as jload
    from gen_fvgn_tpu_torch.training.pool import load_case
    if case == "cylinder":
        d = _cylinder(tmp_path)
    else:
        d = _cavity(tmp_path, *[k for k in KINDS if k[0] == case][0])
    got, ref = load_case(d), jload(d)
    assert got["case_name"] == ref["case_name"] and got["bc"] == ref["bc"]
    assert [tuple(vars(c).values()) for c in got["combos"]] == \
        [tuple(vars(c).values()) for c in ref["combos"]]
    _assert_same(got["mesh"], ref["mesh"], f"load_case {case}",
                 tols={"wlsq_S": 1e-5})


def test_h5_round_trips_through_both_packages(tmp_path):
    from gen_fvgn_tpu.meshes import hdf5 as jh
    from gen_fvgn_tpu.training.pool import load_case as jload
    from gen_fvgn_tpu_torch.meshes import hdf5 as th
    from gen_fvgn_tpu_torch.meshes.comsol import comsol_to_mesh
    from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
    from gen_fvgn_tpu_torch.training.pool import load_case
    d = _cavity(tmp_path, "mixed", "lid", 1)
    mesh = compile_mesh(comsol_to_mesh(os.path.join(d, "mesh.mphtxt")))
    for write, read in ((th.write_mesh_h5, jh.read_mesh_h5),
                        (jh.write_mesh_h5, th.read_mesh_h5),
                        (th.write_mesh_h5, th.read_mesh_h5)):
        path = str(tmp_path / "rt" / "case.h5")
        write(mesh, path, "cavity_mixed")
        back = read(path)
        assert back.pop("case_name") == "cavity_mixed"
        _assert_same(back, mesh, "h5 round trip", 0.0)
    # a case directory with an .h5 is read from it, in both packages
    th.write_mesh_h5(mesh, os.path.join(d, "cavity_mixed.h5"),
                     "cavity_mixed")
    os.remove(os.path.join(d, "mesh.mphtxt"))
    got, ref = load_case(d), jload(d)
    _assert_same(got["mesh"], ref["mesh"], "load_case from .h5",
                 tols={"wlsq_S": 1e-5})
    assert got["mesh"]["case_name"] == "cavity_mixed"


def test_boundary_zone_matches_jax(tmp_path):
    from gen_fvgn_tpu.meshes import boundary as jb
    from gen_fvgn_tpu_torch.meshes import boundary as tb
    from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
    from gen_fvgn_tpu_torch.meshes.synthetic import cavity_quad_mesh
    from gen_fvgn_tpu_torch.meshes.tecplot import tecplot_to_mesh
    mesh = compile_mesh(tecplot_to_mesh(
        os.path.join(_cylinder(tmp_path), "mesh.dat"), "cylinder_pipe"))
    got = tb.extract_boundary_zone(mesh, rho=1.0, mu=0.01, dt=0.1)
    ref = jb.extract_boundary_zone(mesh, rho=1.0, mu=0.01, dt=0.1)
    arrays = lambda z: {k: v for k, v in z.items()
                        if isinstance(v, np.ndarray)}
    _assert_same(arrays(got), arrays(ref), "boundary zone", 0.0)
    assert {k: v for k, v in got.items() if k not in arrays(got)} == \
        {k: v for k, v in ref.items() if k not in arrays(ref)}
    assert got["face|face_node"].shape == (2, 10)   # the obstacle's ring
    edges, keep = tb.filter_subgraph(mesh["face|face_node"],
                                     mesh["node|surf_mask"])
    jedges, jkeep = jb.filter_subgraph(mesh["face|face_node"],
                                       mesh["node|surf_mask"])
    np.testing.assert_array_equal(edges, jedges)
    np.testing.assert_array_equal(keep, jkeep)
    assert tb.extract_boundary_zone(cavity_quad_mesh(3)) is None


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_convert_cli_matches_jax(tmp_path):
    """`convert_case` (the .h5 and the three debug artifacts), `find_meshes`
    and `main` on a COMSOL cavity and a Tecplot pipe flow: the same .h5
    contents and byte-identical .vtu / .vtp files."""
    from gen_fvgn_tpu.meshes import convert as jconv
    from gen_fvgn_tpu_torch.meshes import convert as tconv
    from gen_fvgn_tpu_torch.meshes.hdf5 import read_mesh_h5
    src = tmp_path / "src"
    _cavity(src, "mixed", "lid", 1)
    _cylinder(src)
    roots = {}
    for name in ("port", "jax"):
        roots[name] = str(tmp_path / name)
        shutil.copytree(str(src), roots[name])
    for name, mod in (("port", tconv), ("jax", jconv)):
        meshes = sorted(mod.find_meshes(roots[name]))
        assert [os.path.basename(m) for m in meshes] == ["mesh.mphtxt",
                                                         "mesh.dat"] or \
            [os.path.basename(m) for m in meshes] == ["mesh.dat",
                                                      "mesh.mphtxt"]
        for m in meshes:
            assert mod.convert_case(m).endswith(".h5")
    for case in ("cavity_mixed", "cylinder_pipe"):
        t_dir = os.path.join(roots["port"], case)
        j_dir = os.path.join(roots["jax"], case)
        _assert_same(read_mesh_h5(os.path.join(t_dir, f"{case}.h5")),
                     read_mesh_h5(os.path.join(j_dir, f"{case}.h5")),
                     f"{case}.h5", 0.0)
        artifacts = ["node_type_with_mesh.vtu", "face_type_in_scatter.vtu"]
        if case == "cylinder_pipe":
            artifacts.append("surf_edge.vtp")
        for art in artifacts:
            assert _read(os.path.join(t_dir, art)) == \
                _read(os.path.join(j_dir, art)), (case, art)
    # the CLI, in place, without the debug artifacts
    out = str(tmp_path / "cli_out")
    tconv.main(["--dir", str(src), "--out", out, "--workers", "1",
                "--no-debug-artifacts"])
    assert sorted(os.listdir(out)) == ["cavity_mixed.h5", "cylinder_pipe.h5"]


def test_vtu_writers_are_byte_identical_to_jax(tmp_path):
    from gen_fvgn_tpu.io import vtu as jv
    from gen_fvgn_tpu_torch.io import vtu as tv
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(9, 2))
    cells_node = np.asarray([0, 1, 4, 3, 1, 2, 5, 4, 3, 4, 7, 3, 7, 6,
                             4, 5, 8, 7, 6, 2])
    cells_index = np.asarray([0] * 4 + [1] * 4 + [2] * 3 + [3] * 3
                             + [4] * 6)
    pdata = {"node|u": rng.normal(size=9), "uv": rng.normal(size=(9, 2)),
             "skip": np.zeros(4)}
    cdata = {"cell|p": rng.normal(size=5).astype(np.float32)}
    calls = [
        ("write_vtu_2d", (pos, cells_node, cells_index),
         dict(point_data=pdata, cell_data=cdata)),
        ("write_vtu_2d", (pos, cells_node, cells_index), {}),
        ("write_point_cloud_vtu", (pos,), dict(point_data=pdata)),
        ("write_point_cloud_vtu", (np.c_[pos, pos[:, :1]],), {}),
        ("write_vtp_polyline", (pos[:4], np.asarray([[0, 1, 2], [1, 2, 3]])),
         {})]
    for i, (fn, args, kw) in enumerate(calls):
        paths = [str(tmp_path / pkg / f"{i}.out") for pkg in ("t", "j")]
        getattr(tv, fn)(paths[0], *args, **kw)
        getattr(jv, fn)(paths[1], *args, **kw)
        assert _read(paths[0]) == _read(paths[1]), fn


@pytest.fixture
def fixed_clock(monkeypatch):
    """The wall time and host name that event files carry, fixed."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")


def test_event_writer_is_byte_identical_to_jax(tmp_path, fixed_clock):
    from gen_fvgn_tpu.io import tb_events as je
    from gen_fvgn_tpu_torch.io import tb_events as te
    for data in (b"", b"a", b"123456789", bytes(range(256))):
        assert te.crc32c(data) == je.crc32c(data)
    assert te.crc32c(b"123456789") == 0xE3069283    # the CRC-32C check value
    values = np.random.default_rng(1).normal(size=100)
    writers = [mod.EventWriter(str(tmp_path / name))
               for mod, name in ((te, "t"), (je, "j"))]
    for w in writers:
        w.add_scalar("loss", 0.125, 3)
        w.add_scalar("lr", 5e-5, 2 ** 40)
        w.add_histogram("h", values, 7)
        w.add_histogram("const", np.full(5, 2.0), 8)
        w.add_histogram("h", np.arange(12.0).reshape(3, 4), 9, bins=5)
        with pytest.warns(UserWarning, match="no finite"):
            w.add_histogram("nan", np.full(3, np.nan), 10)
        w.close()
    assert os.path.basename(writers[0].path) == \
        os.path.basename(writers[1].path) == \
        "events.out.tfevents.1700000000.host"
    assert _read(writers[0].path) == _read(writers[1].path)


def test_logger_events_are_byte_identical_to_jax(tmp_path, fixed_clock):
    """`RunLogger(use_tensorboard=True)`: the scalars of `log_scalars`, a
    value histogram and the parameter histogram of the same weights (the
    port's simulator and the JAX parameter tree) give the same event file."""
    from gen_fvgn_tpu.io.logger import RunLogger as JLogger
    from gen_fvgn_tpu_torch.io.logger import RunLogger
    from torch_port_common import (both_sides, numpy_params,
                                   torch_simulator)
    (jc, _, js, jd), (tc, _, _, _) = both_sides(6, 32, 1, "float32", 2,
                                                "TransFVGN_v2")
    tree, _ = numpy_params(jc, js, jd)
    sim = torch_simulator(tc, tree)
    jparams = {"params": {k: v for k, v in tree.items()}}
    loggers = [RunLogger(str(tmp_path / "t"), tc, seed=0, run_name="r",
                         copy_code=False, use_tensorboard=True),
               JLogger(str(tmp_path / "j"), jc, seed=0, run_name="r",
                       copy_code=False, use_tensorboard=True)]
    values = np.random.default_rng(2).normal(size=50)
    for lg, params in zip(loggers, (sim, jparams)):
        lg.log_scalars(0, {"loss": 1.5, "lr": 5e-5})
        lg.log_scalars(1, {"loss": 1.25, "lr": 5e-5})
        lg.log_histogram("values", values, 1)
        lg.log_param_histogram(params, 1)
    loggers[0].close()
    loggers[1]._tb.close()
    files = [os.path.join(lg.run_dir, "tb", f)
             for lg in loggers for f in os.listdir(os.path.join(lg.run_dir,
                                                                "tb"))]
    assert len(files) == 2 and _read(files[0]) == _read(files[1])
    assert _read(os.path.join(loggers[0].run_dir, "Loss_monitor.dat")) == \
        _read(os.path.join(loggers[1].run_dir, "Loss_monitor.dat"))
    # without TensorBoard the histograms write nothing
    quiet = RunLogger(str(tmp_path / "q"), tc, run_name="r", copy_code=False)
    quiet.log_histogram("values", values, 0)
    quiet.log_param_histogram(sim, 0)
    quiet.close()
    assert not os.path.exists(os.path.join(quiet.run_dir, "tb"))
