"""PyTorch port, the package as a whole: it imports nothing of JAX or of
the JAX package, its entry points refuse to run on the CPU unasked, its
Config round-trips, and what it does not port yet says so."""

import pathlib
import re

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "gen_fvgn_tpu_torch"

FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax\b"),
    re.compile(r"^\s*(import|from)\s+flax\b"),
    re.compile(r"^\s*(import|from)\s+optax\b"),
    re.compile(r"^\s*(import|from)\s+orbax\b"),
    re.compile(r"\bgen_fvgn_tpu\."),
    re.compile(r"\bfrom\s+gen_fvgn_tpu\s"),
    re.compile(r"\bimport\s+gen_fvgn_tpu\b(?!_torch)"),
]


def _port_files():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    hits = []
    for no, line in enumerate(path.read_text().splitlines(), 1):
        code = line.split("#", 1)[0] if path.suffix == ".py" else line
        for pat in FORBIDDEN:
            if pat.search(code):
                hits.append(f"{path.name}:{no}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_importing_the_port_loads_no_jax_module():
    """Import every module of the port in a fresh interpreter: neither jax,
    flax nor the JAX package may come along."""
    import subprocess
    import sys
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {"gen_fvgn_tpu_torch.models.transolver",
            "gen_fvgn_tpu_torch.ops.fused_slice_attn",
            "gen_fvgn_tpu_torch.ops.pair_spmm",
            "gen_fvgn_tpu_torch.training.train",
            "gen_fvgn_tpu_torch.training.train_block",
            "gen_fvgn_tpu_torch.training.loop",
            "gen_fvgn_tpu_torch.io.checkpoint",
            "gen_fvgn_tpu_torch.solve.lbfgs",
            "gen_fvgn_tpu_torch.solve.instance_opt",
            "gen_fvgn_tpu_torch.meshes.comsol",
            "gen_fvgn_tpu_torch.meshes.tecplot",
            "gen_fvgn_tpu_torch.meshes.hdf5",
            "gen_fvgn_tpu_torch.meshes.boundary",
            "gen_fvgn_tpu_torch.meshes.convert",
            "gen_fvgn_tpu_torch.io.vtu",
            "gen_fvgn_tpu_torch.io.tb_events",
            "gen_fvgn_tpu_torch.scripts.pre_train",
            "gen_fvgn_tpu_torch.scripts.solve",
            "gen_fvgn_tpu_torch.tools.case_files",
            "gen_fvgn_tpu_torch.models.simulator",
            "gen_fvgn_tpu_torch.ops.interp",
            "gen_fvgn_tpu_torch.solve.rollout"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'gen_fvgn_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-2000:]


def _small_case():
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    return synthetic_case(cavity_quad_mesh(4), continuity=1, convection=1,
                          grad_p=1, mu=0.05, sigma=(1, 1, 1))


def _entry_points(tmp_path):
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.convert import normalizer_from_numpy
    from gen_fvgn_tpu_torch.graph.packs import build_static_pack
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net="FVGN", batch_size=1, dataset_size=1, hidden_size=32,
                 message_passing_num=1)

    def static_pack(**kw):
        pool = EnvPool([], cfg, cases=[_small_case()], device="cpu")
        return build_static_pack(pool.cases[0]["mesh"], cfg.order,
                                 pool.case_sizes[0], node_agg="composed",
                                 **kw)
    from gen_fvgn_tpu_torch.training.train_block import (
        init_train_state_block, make_train_step_block)
    from gen_fvgn_tpu_torch.solve.instance_opt import (solve_adam_block,
                                                       solve_lbfgs_block)
    from gen_fvgn_tpu_torch.graph.sample import stack_samples
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    from gen_fvgn_tpu_torch.solve.instance_opt import solve_adam, solve_lbfgs
    from gen_fvgn_tpu_torch.training.loop import train
    from gen_fvgn_tpu_torch.training.train import (init_train_state,
                                                   make_train_step)

    def segment_pool(**kw):
        return EnvPool([], cfg, cases=[_small_case()], engine="segment",
                       **kw)

    def segment_solve(fn, **kw):
        pool = segment_pool(device="cpu")
        return fn(cfg, make_simulator(cfg, device="cpu"),
                  init_normalizer(9, device="cpu"),
                  pool.gather_batch(np.arange(1)), 1, 1, **kw)

    def solve(fn, **kw):
        pool = EnvPool([], cfg, cases=[_small_case()], device="cpu")
        sim = make_simulator_block(cfg, device="cpu")
        return fn(cfg, sim, init_normalizer(9, device="cpu"),
                  pool.gather_block(np.arange(1)), pool.statics[0], 1, 1,
                  **kw)
    return {
        "train": lambda **kw: train(
            cfg.replace(engine="block", max_inner_steps=1),
            cases=[_small_case()], log_base_dir=str(tmp_path), n_epochs=1,
            **kw),
        "solve_adam_block": lambda **kw: solve(solve_adam_block, **kw),
        "solve_lbfgs_block": lambda **kw: solve(solve_lbfgs_block, **kw),
        "EnvPool": lambda **kw: EnvPool([], cfg, cases=[_small_case()], **kw),
        "init_train_state_block": lambda **kw: init_train_state_block(
            cfg, **kw),
        "make_train_step_block": lambda **kw: make_train_step_block(
            cfg, make_simulator_block(cfg, device="cpu"), **kw),
        "make_simulator_block": lambda **kw: make_simulator_block(cfg, **kw),
        "init_normalizer": lambda **kw: init_normalizer(9, **kw),
        "build_static_pack": static_pack,
        "normalizer_from_numpy": lambda **kw: normalizer_from_numpy(
            np.zeros(9), np.ones(9), 1.0, 1.0, **kw),
        "train[segment]": lambda **kw: train(
            cfg.replace(engine="segment", max_inner_steps=1),
            cases=[_small_case()], log_base_dir=str(tmp_path), n_epochs=1,
            **kw),
        "EnvPool[segment]": segment_pool,
        "stack_samples": lambda **kw: stack_samples(
            [segment_pool(device="cpu").envs[0].sample], **kw),
        "make_simulator": lambda **kw: make_simulator(cfg, **kw),
        "init_train_state": lambda **kw: init_train_state(cfg, **kw),
        "make_train_step": lambda **kw: make_train_step(
            cfg, make_simulator(cfg, device="cpu"), **kw),
        "solve_adam": lambda **kw: segment_solve(solve_adam, **kw),
        "solve_lbfgs": lambda **kw: segment_solve(solve_lbfgs, **kw),
    }


@pytest.mark.parametrize("name", ["EnvPool", "make_simulator_block",
                                  "init_normalizer", "build_static_pack",
                                  "normalizer_from_numpy",
                                  "init_train_state_block",
                                  "make_train_step_block", "train",
                                  "solve_adam_block", "solve_lbfgs_block",
                                  "train[segment]", "EnvPool[segment]",
                                  "stack_samples", "make_simulator",
                                  "init_train_state", "make_train_step",
                                  "solve_adam", "solve_lbfgs"])
def test_entry_point_defaults_to_cuda_and_raises_without_a_card(name,
                                                                tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    fn = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="cuda"):
        fn()                                    # the default device
    with pytest.raises(RuntimeError, match="cuda"):
        fn(device="cuda")
    fn(device="cpu")                            # the CPU only when asked


def test_same_device_reads_cuda_as_the_current_card(monkeypatch):
    """A train step made for device="cuda" takes a batch on "cuda:0" (what
    tensors report) when card 0 is current, and refuses the CPU or another
    card."""
    from gen_fvgn_tpu_torch.utils.device import same_device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert same_device("cuda", "cuda:0") and same_device("cuda:0", "cuda")
    assert same_device("cpu", torch.device("cpu"))
    assert not same_device("cuda", "cuda:1")
    assert not same_device("cuda:0", "cpu")
    assert not same_device("cpu", "cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """Where no nvcc exists the build raises; it never gives way to the
    plain version."""
    import shutil

    from gen_fvgn_tpu_torch.ops import _cuda_build
    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(_cuda_build, "_LIB", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda_build.load_library()


def test_config_round_trips_and_matches_the_jax_fields():
    import dataclasses

    from gen_fvgn_tpu.config import Config as JConfig
    from gen_fvgn_tpu_torch.config import Config
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(Config)}
    assert jf == tf
    cfg = Config(net="FVGN", hidden_size=64, fv_ell=True)
    assert Config.from_json(cfg.to_json()) == cfg
    assert Config.from_json(JConfig(net="FVGN").to_json()) == \
        Config(net="FVGN")
    assert cfg.edge_input_size == 15 and cfg.wlsq_dim == 5


@pytest.mark.parametrize("net", ["TransFVGN_v1", "TransFVGN_v2", "TransFVGN"])
def test_transolver_net_builds_with_the_flax_paths(net):
    """Each Transolver net builds on the CPU, and its state_dict has exactly
    the flax parameter paths of the JAX package's net, with the same shapes
    (`graph_temperature` [1, H, 1] and the `processor_{i}.gn_{j}` nesting
    included), so a converted tree loads key by key."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from torch_port_common import both_sides, numpy_params
    (jc, _, js, jd), (tc, _, _, _) = both_sides(6, 32, 1, "float32", 1, net)
    tree, _ = numpy_params(jc, js, jd)
    sd = params_from_flax(tree)
    sim = make_simulator_block(Config(net=net, hidden_size=32,
                                      message_passing_num=1), device="cpu")
    mine = sim.state_dict()
    assert set(sd) == set(mine)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}
    sim.load_state_dict(sd, strict=True)
    prefix = "transolver." if net == "TransFVGN_v1" \
        else "processor_1.transolver."
    assert tuple(mine[prefix + "attn.graph_temperature"].shape) == (1, 8, 1)
    assert prefix + "attn.to_q.kernel" in mine
    assert prefix + "attn.to_q.bias" not in mine
    if net != "TransFVGN_v1":
        assert "processor_0.gn_0.edge_block.edge_mlp.ln.scale" in mine


def test_unknown_net_and_unported_options_raise():
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.models.gn_block import NodeBlockB
    from gen_fvgn_tpu_torch.models.simulator_block import make_simulator_block
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    with pytest.raises(ValueError):
        make_simulator_block(Config(net="nope"), device="cpu")
    with pytest.raises(NotImplementedError):
        NodeBlockB(32, node_agg="split")
    with pytest.raises(FileNotFoundError):     # case directories are read
        EnvPool(["some_dir"], Config(net="FVGN"), device="cpu")
    with pytest.raises(NotImplementedError):
        EnvPool([], Config(net="FVGN"), cases=[_small_case()],
                engine="segment", bucket_tiers=True, device="cpu")


def test_normalizer_from_numpy_and_types():
    from gen_fvgn_tpu_torch.convert import normalizer_from_numpy
    from gen_fvgn_tpu_torch.utils.types import NodeType
    st = normalizer_from_numpy(np.arange(9.0), np.ones(9), 4.0, 2.0,
                               device="cpu")
    assert st.acc_sum.dtype == torch.float32 and float(st.acc_count) == 4.0
    assert tuple(st.num_acc.shape) == ()
    from gen_fvgn_tpu.utils.types import NodeType as JNodeType
    assert {t.name: int(t) for t in NodeType} == \
        {t.name: int(t) for t in JNodeType}
