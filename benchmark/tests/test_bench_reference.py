"""The plain reference against the float64 transcription of the FV scheme
(`tests/reference_oracle.py`) at a small mesh, and against the system on
the CPU in float32."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from benchmark.harness import case, spec, weights
from benchmark.reference import fv, mesh, physics, step

ORACLE = spec.ROOT / "tests" / "reference_oracle.py"


def _oracle():
    s = importlib.util.spec_from_file_location("bench_reference_oracle",
                                               ORACLE)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _oracle_mesh(st):
    half = st.st_out.shape[0] // 2
    return {"node|pos": st.pos, "face|face_node": st.face_node,
            "face|face_type": st.face_type,
            "face|face_area": st.face_area[:, None],
            "face|face_center_pos": st.face_center,
            "cell|centroid": st.centroid, "cell|cells_area": st.cells_area,
            "cells_node": st.slot_node, "cells_face": st.slot_face,
            "cells_index": st.slot_cell, "unit_norm_v": st.slot_unv,
            "stencil": np.stack([st.st_out[:half], st.st_in[:half]])}


BC = json.loads((spec.BENCH_DIR / "configs" / "transfvgn_v2.json")
                .read_text())["assumed"]["bc"]


@pytest.mark.parametrize("n", [4, 9])
def test_fv_residual_matches_the_oracle(n):
    oracle = _oracle()
    st = mesh.statics(mesh.cavity(n))
    rng = np.random.default_rng(n)
    coef = dict(BC["theta_PDE"], sigma=BC["sigma"])
    env = physics.env_physics(coef, dict(u=1.25, rho=1.0, mu=0.03, source=0.0,
                                         aoa=0.0, dt=0.05, L=1.0),
                              st.node_type)
    uvp = rng.normal(size=(st.n_nodes, 3)) * 0.3
    old = rng.normal(size=(st.n_nodes, 2)) * 0.3
    hat = 0.5 * (uvp[:, :2] + old)
    want = oracle.integrator_forward(
        uvp, hat, old, _oracle_mesh(st), env["target_uv"], env["theta"],
        env["sigma"], env["dt"])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    got, rt, cell = fv.residual(
        step.statics_tensors(st, "cpu"), t(uvp), t(hat), t(old),
        {k: t(v) for k, v in env.items()})
    for k in ("cont", "mom_x", "mom_y"):
        assert float(got[k]) == pytest.approx(want["loss_" + k], rel=2e-5)
    assert float(got["press"]) == want["loss_press"] == 0.0
    np.testing.assert_allclose(rt.numpy(), want["rt_uvp_new"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(cell.numpy(), want["uvp_cell_new"],
                               rtol=1e-4, atol=1e-6)


def test_node_types_of_the_cavity():
    t = mesh.node_types(mesh.cavity(3))
    # rows from y = 0: bottom wall, sides, the lid with IN_WALL corners
    assert t.reshape(4, 4).tolist() == [[3, 3, 3, 3], [3, 0, 0, 3],
                                        [3, 0, 0, 3], [5, 1, 1, 5]]


@pytest.mark.parametrize("engine,net", [("segment", "TransFVGN_v2"),
                                        ("block", "FVGN")])
def test_step_matches_the_system_in_float32(tmp_path, engine, net):
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    from gen_fvgn_tpu_torch.models.simulator_block import \
        make_simulator_block
    from gen_fvgn_tpu_torch.solve.rollout import make_eval_step
    from gen_fvgn_tpu_torch.solve.rollout_block import make_eval_step_block
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    from gen_fvgn_tpu_torch.training.pool import EnvPool

    from benchmark.harness.cells import node_order
    from benchmark.reference.model import Net
    raw = mesh.cavity(6)
    d = case.write_case(str(tmp_path / "cav"), raw, BC)
    cfg = Config(net=net, mxu_dtype="float32", engine=engine, tile=64,
                 batch_size=2, dataset_size=2)
    pool = EnvPool([d], cfg, seed=5, dataset_size=2, engine=engine,
                   tile=64, device="cpu")
    cd = json.loads(cfg.to_json())
    w = weights.draw(cd, 9, "cpu")
    sim = (make_simulator if engine == "segment"
           else make_simulator_block)(cfg, device="cpu")
    with torch.no_grad():
        for k, p in sim.named_parameters():
            p.copy_(w[k])
    ns = init_normalizer(9, device="cpu")
    if engine == "segment":
        out = make_eval_step(cfg, sim)(ns, pool.gather_batch(np.arange(2)))
    else:
        out = make_eval_step_block(cfg, sim)(
            ns, pool.gather_block(np.arange(2)), pool.statics[0])
    order = node_order(np.asarray(pool.cases[0]["mesh"]["node|pos"]),
                       raw.pos)
    st = mesh.statics(raw.renumber(order))
    stt = step.statics_tensors(st, "cpu")
    coef = dict(BC["theta_PDE"], sigma=BC["sigma"])
    net_r = Net(w, cd)
    for b, e in enumerate(pool.envs[:2]):
        ts = e.theta_sample
        env = step.env_tensors(physics.env_physics(coef, dict(
            u=ts.mean_u, rho=ts.rho, mu=ts.mu, source=ts.source, aoa=ts.aoa,
            dt=ts.dt, L=ts.L), st.node_type), "cpu")
        with torch.no_grad():
            losses, node, _ = step.forward(
                net_r, stt, env["uvp0"], env, torch.zeros(9), torch.ones(9))
        got = out.uvp_node_new[b, :st.n_nodes]
        rel = (got - node).norm() / node.norm()
        assert float(rel) < 5e-4
        assert float(out.loss_cont[b]) == pytest.approx(
            float(losses["cont"]), rel=1e-3)
