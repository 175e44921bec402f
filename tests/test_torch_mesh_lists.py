"""PyTorch port, the segment engine's kernel lists (`ops.mesh_lists`): built
once where the batch's topology is fixed, and passed down.

On the CPU (no card needed), with `ops.mesh_lists` replaced by a counting
builder that builds the lists on the CPU (whose passes then run their plain
versions through them): `rollout()` over 3 steps builds once, runs every
step's FV residual on the lists, and its records equal, bit for bit, those
of the same 3 steps each building its own (`forward_batch` builds once a
call where it is given none); an unchunked `_Problem` of the solves builds
once over several `value_and_grad` calls and its final forward, with the
loss of a forward that builds its own; a chunked one builds once a chunk.

On the card (marker `cuda`, skipped without one): a rollout on lists built
once equals, bit for bit, one that builds them every step, and launches the
FV lists' build once; `ops.mesh_lists` there. Run it with

    python -m pytest tests/test_torch_mesh_lists.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from gen_fvgn_tpu_torch import ops
from gen_fvgn_tpu_torch.config import Config

RECORDS = ("loss_cont", "loss_mom_x", "loss_mom_y", "loss_press",
           "uvp_node", "uvp_cell")


def _setup(cfg, device, n=5):
    """(batch of every environment, simulator, normalizer state) of a
    segment pool of one n x n-cell cavity."""
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    pool = EnvPool([], cfg, seed=0, engine="segment", device=device,
                   cases=[synthetic_case(
                       cavity_quad_mesh(n), continuity=1, convection=1,
                       grad_p=1, mu=0.05, sigma=(1, 1, 1))])
    batch = pool.gather_batch(np.arange(cfg.batch_size))
    ns = init_normalizer(cfg.node_input_size - cfg.node_phi_size,
                         device=device)
    return batch, make_simulator(cfg, device=device, seed=0), ns


CPU_CFG = Config(net="FVGN", hidden_size=32, message_passing_num=2,
                 batch_size=2, dataset_size=2, engine="segment")


@pytest.fixture
def builds(monkeypatch):
    """`ops.mesh_lists` replaced by a builder of the lists on the CPU;
    the batch sizes it was called with, in order."""
    from gen_fvgn_tpu_torch.ops import fv_csr, segment_csr
    calls = []

    def build(batch, cfg):
        calls.append(batch.uvp.shape[0])
        return ops.MeshLists(
            segment_csr.build_incidence(batch.face_node, batch.face_mask,
                                        batch.uvp.shape[1]),
            fv_csr.build_lists(batch))
    monkeypatch.setattr(ops, "mesh_lists", build)
    return calls


def test_rollout_builds_the_lists_once(builds):
    from gen_fvgn_tpu_torch.fv import integrator
    from gen_fvgn_tpu_torch.solve.rollout import (make_eval_step, march,
                                                  rollout)
    batch, sim, ns = _setup(CPU_CFG, "cpu")
    calls = (integrator.FV_KERNEL_CALLS, integrator.FV_PLAIN_CALLS)
    once = rollout(CPU_CFG, sim, ns, batch, 3)
    assert builds == [2]
    assert (integrator.FV_KERNEL_CALLS, integrator.FV_PLAIN_CALLS) == (
        calls[0] + 3, calls[1])
    step = make_eval_step(CPU_CFG, sim)
    each = march(lambda b: step(ns, b), batch, 3)
    assert builds == [2] * 4
    assert np.abs(once[-1]["uvp_node"] - once[0]["uvp_node"]).max() > 0
    for a, b in zip(once, each):
        for key in RECORDS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_unchunked_problem_builds_the_lists_once(builds):
    from gen_fvgn_tpu_torch.solve.instance_opt import _Problem
    from gen_fvgn_tpu_torch.training.forward import (forward_batch,
                                                     training_loss)
    batch, sim, ns = _setup(CPU_CFG, "cpu")
    prob = _Problem(CPU_CFG, sim, ns, batch)
    assert not prob.chunked and builds == [2]
    losses = [prob.value_and_grad()[0] for _ in range(3)]
    prob.final_outputs()
    assert builds == [2]
    with torch.no_grad():
        own = training_loss(forward_batch(sim, ns, batch, CPU_CFG,
                                          accumulate_normalizer=False),
                            CPU_CFG)
    assert builds == [2, 2]
    for loss in losses:
        assert torch.equal(loss, own)
    chunked = _Problem(CPU_CFG.replace(microbatch=1), sim, ns, batch)
    assert chunked.chunked and builds == [2, 2]
    chunked.value_and_grad()
    assert builds == [2, 2, 1, 1]


@pytest.mark.cuda
def test_rollout_on_lists_built_once_equals_per_step_build_on_card():
    """The Config's defaults (TransFVGN_v2, bf16) at batch 2 on a
    16 x 16-node cavity: 3 rollout steps on lists built once against 3
    steps each building its own, the same bits; the FV lists' build
    launched once against once a step. `ops.mesh_lists` on the card: the
    incidence lists of `build_incidence`, no FV lists at the conserved
    form off, None inside `ops.plain_versions()`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no "
                    "interpret mode")
    from gen_fvgn_tpu_torch.ops import segment_csr
    from gen_fvgn_tpu_torch.solve.rollout import (make_eval_step, march,
                                                  rollout)
    cfg = Config(batch_size=2, dataset_size=2)
    batch, sim, ns = _setup(cfg, "cuda", n=15)
    lists = ops.mesh_lists(batch, cfg)
    want = segment_csr.build_incidence(batch.face_node, batch.face_mask,
                                       batch.uvp.shape[1])
    assert all(torch.equal(a, b) for a, b in zip(lists.inc, want))
    assert lists.fv is not None
    assert ops.mesh_lists(batch, cfg.replace(conserved_form=False)).fv \
        is None
    with ops.plain_versions():
        assert ops.mesh_lists(batch, cfg) is None
    ops.zero_launch_counts()
    once = rollout(cfg, sim, ns, batch, 3)
    n_once = ops.launch_counts()
    ops.zero_launch_counts()
    step = make_eval_step(cfg, sim)
    each = march(lambda b: step(ns, b), batch, 3)
    n_each = ops.launch_counts()
    assert (n_once["fv_lists"], n_each["fv_lists"]) == (3, 9)
    assert n_once["fv_wlsq"] == n_each["fv_wlsq"] == 3
    assert n_once["seg_nbr_sum"] == n_each["seg_nbr_sum"] > 0
    assert np.abs(once[-1]["uvp_node"] - once[0]["uvp_node"]).max() > 0
    for a, b in zip(once, each):
        for key in RECORDS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
