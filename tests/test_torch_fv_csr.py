"""PyTorch port, the segment engine's FV residual on list passes
(`ops/fv_csr.py`, kernels in `csrc/fv_csr.cu`) against the plain path of
`fv/integrator.py::integrate_residuals` (`ops/wlsq.py`, `ops/interp.py`,
`ops/segment.py`).

On the CPU (no card needed), on three batches: the cavity with an outflow
wall (so the pressure-outlet residual is exercised), a mixed batch (a
quadrilateral and a triangular cavity padded to one size, so lanes have
their own meshes) and a bucket-tier batch:
* the lists hold every unmasked slot once under its cell, its node and
  its face, every unmasked stencil entry once under each end, every
  unmasked face once under each node, each list in ascending entry order;
* the passes' plain versions through the lists (which CPU tensors take)
  equal the plain path: the four losses within 1e-6 relative, `rt_uvp`
  and `uvp_cell` within 1e-6 of their scale, with `ncn_smooth` both
  ways; and the gradients with respect to `uvp_new`, `uv_hat` and
  `uv_old` of random cotangents on every output within 1e-6 of their
  scale;
* `integrate_residuals` takes the list passes exactly when it is given
  the batch's FV lists, which `ops.mesh_lists` builds on the card alone
  and at the forms the kernels cover, and the call counters say so.

On the card (marker `cuda`, skipped without one): the kernels against the
plain CUDA chain at a small shape and at the benchmark cells' shape (the
201 x 201-node cavity, batch 8), forward and backward, within 1e-6 of the
scale (losses relative), two runs the same bits, and the lists equal to
the stable sort's. Run them with

    python -m pytest tests/test_torch_fv_csr.py -q -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_common import CASE_KW, _with_outflow

from gen_fvgn_tpu_torch.ops import fv_csr

LOSSES = ("cont", "mom_x", "mom_y", "press")
# every term of the residual on: the unsteady term too, so that uv_old has
# a gradient
KW = dict(CASE_KW, unsteady=1)


def outflow_cavity(n):
    """The cavity of n x n cells with its right wall an outflow, compiled
    again from the node types so that its faces carry the outflow type."""
    from gen_fvgn_tpu_torch.meshes.geometry import compile_mesh
    from gen_fvgn_tpu_torch.meshes.synthetic import cavity_quad_mesh
    mesh = _with_outflow(cavity_quad_mesh(n))
    return compile_mesh({k: mesh[k] for k in (
        "node|pos", "node|node_type", "cells_node", "cells_index")})


@functools.lru_cache(maxsize=None)
def _pool(kind):
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     cavity_tri_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net="FVGN", batch_size=2 if kind == "tier" else 3,
                 dataset_size=4, hidden_size=32,
                 message_passing_num=1, engine="segment")
    kw = dict(seed=0, engine="segment", device="cpu")
    if kind == "outflow":
        cases = [synthetic_case(outflow_cavity(6), **KW)]
    else:
        cases = [synthetic_case(cavity_quad_mesh(5), **KW),
                 synthetic_case(cavity_tri_mesh(6), **KW)]
    return EnvPool([], cfg, cases=cases, bucket_tiers=kind == "tier", **kw)


def batch_of(kind):
    """A stacked MeshSample of CPU tensors."""
    pool = _pool(kind)
    if kind == "tier":
        assert pool.n_tiers == 2
        return pool.gather_batch(pool.batch_indices(step_seed=1)[0])
    idx = np.arange(3) if kind == "outflow" else np.asarray([0, 2, 1])
    batch = pool.gather_batch(idx)
    if kind == "mixed":
        n_real = [int(m) for m in batch.node_mask.sum(1)]
        assert len(set(n_real)) == 2, "the lanes have their own meshes"
    return batch


def states(batch, seed):
    """Random (uvp_new, uv_hat, uv_old), zero on padded nodes."""
    g = torch.Generator().manual_seed(seed)
    m = batch.node_mask[..., None].float()
    rnd = lambda c: torch.randn(batch.pos.shape[:2] + (c,), generator=g) * m
    return rnd(3), rnd(2), rnd(2)


def scaled_gap(got, ref):
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / max(scale, 1e-30)


def _plain(new, hat, old, batch, ncn, conserved=True):
    from gen_fvgn_tpu_torch.fv.integrator import integrate_residuals
    losses, rt, cell = integrate_residuals(new, hat, old, batch, "2nd",
                                           conserved, ncn)
    return tuple(losses), rt, cell


def _lists_path(new, hat, old, batch, ncn):
    return fv_csr.residual(new, hat, old, batch, ncn,
                           fv_csr.build_lists(batch))


def _with_grads(fn, batch, ncn, seed):
    """fn's outputs and the gradients of random cotangents on all of them
    with respect to the three states."""
    ins = [t.requires_grad_(True) for t in states(batch, seed)]
    losses, rt, cell = fn(*ins, batch, ncn)
    g = torch.Generator().manual_seed(seed + 100)
    outs = list(losses) + [cell] + ([rt] if ncn else [])
    cots = [torch.randn(o.shape, generator=g) for o in outs]
    grads = torch.autograd.grad(outs, ins, cots)
    return [o.detach() for o in losses], rt.detach(), cell.detach(), grads


# ---- CPU ----

@pytest.mark.parametrize("kind", ["outflow", "mixed", "tier"])
def test_lists(kind):
    """Each family's lists against a loop over the entries."""
    batch = batch_of(kind)
    lists = fv_csr.build_lists(batch)
    b, n, e, c, k, s = lists.sizes
    o = lists.offsets()
    ptr = lists.ptr.long()
    assert lists.ptr.dtype == lists.ids.dtype == torch.int32
    assert int(ptr[0]) == 0 and bool((torch.diff(ptr) >= 0).all())
    assert int(ptr[-1]) <= lists.ids.shape[0]
    expect = {r: [] for r in range(o[-1])}
    fn, st = batch.face_node.long(), batch.stencil.long()
    for bi in range(b):
        for i in range(k):
            if batch.slot_mask[bi, i]:
                slot = bi * k + i
                expect[o[0] + bi * c + int(batch.cells_index[bi, i])].append(
                    slot)
                expect[o[1] + bi * n + int(batch.cells_node[bi, i])].append(
                    slot)
                expect[o[2] + bi * e + int(batch.cells_face[bi, i])].append(
                    slot)
        for fam, idx, live, m in ((3, st, batch.stencil_mask, s),
                                  (4, fn, batch.face_mask, e)):
            for j in range(m):
                if live[bi, j]:
                    for side in (0, 1):
                        expect[o[fam] + bi * n + int(idx[bi, side, j])
                               ].append((bi * m + j) * 2 + side)
    for r, want in expect.items():
        got = lists.ids[ptr[r]:ptr[r + 1]].tolist()
        assert got == sorted(want), f"row {r}"
    # every face has at most two slots, every cell at least three
    f_lens = torch.diff(ptr[o[2]:o[3] + 1])
    assert int(f_lens.max()) <= 2
    c_lens = torch.diff(ptr[o[0]:o[1] + 1]).reshape(b, c)
    assert bool((c_lens[batch.cell_mask] >= 3).all())


@pytest.mark.parametrize("ncn", [True, False], ids=["ncn", "no-ncn"])
@pytest.mark.parametrize("kind", ["outflow", "mixed", "tier"])
def test_passes_through_lists_equal_plain_path(kind, ncn):
    """Forward: the four losses within 1e-6 relative, rt_uvp and uvp_cell
    within 1e-6 of their scale; backward: the three states' gradients of
    random cotangents on every output within 1e-6 of their scale."""
    batch = batch_of(kind)
    got = _with_grads(_lists_path, batch, ncn, 7)
    ref = _with_grads(_plain, batch, ncn, 7)
    for name, a, r in zip(LOSSES, got[0], ref[0]):
        assert a.shape == r.shape == (batch.pos.shape[0],)
        torch.testing.assert_close(a, r, rtol=1e-6, atol=0,
                                   msg=f"loss {name}")
    if kind == "outflow":
        assert bool((ref[0][3] > 0).all()), "the outflow loss is exercised"
    assert scaled_gap(got[1], ref[1]) <= 1e-6
    assert scaled_gap(got[2], ref[2]) <= 1e-6
    for name, a, r in zip(("uvp_new", "uv_hat", "uv_old"), got[3], ref[3]):
        assert a.shape == r.shape
        assert float(r.abs().max()) > 0
        assert scaled_gap(a, r) <= 1e-6, name


def test_loss_gradients_alone_equal_plain_path():
    """The train step's case: a cotangent on the losses only (the states go
    to the pool), so `uvp_cell` and `rt_uvp` get none."""
    batch = batch_of("outflow")
    grads = []
    for fn in (_lists_path, _plain):
        ins = [t.requires_grad_(True) for t in states(batch, 3)]
        losses, _, _ = fn(*ins, batch, True)
        total = torch.log(sum(losses)).sum()
        grads.append(torch.autograd.grad(total, ins[:2]))
    for a, r in zip(*grads):
        assert scaled_gap(a, r) <= 1e-6


def test_dispatch_and_counters():
    """`integrate_residuals` takes the list passes exactly when it is
    given the batch's FV lists (`fv_lists`), and the call counters say so:
    without them the plain path, on the CPU and inside
    `ops.plain_versions()` alike; with them (built on the CPU, whose passes
    run their plain versions through them) the list passes, no kernel
    launched. `ops.mesh_lists` gives CPU tensors no lists, and no FV lists
    at the forms the passes do not cover (conserved_form=False, another
    order), where `integrate_residuals` refuses them."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.fv import integrator
    from gen_fvgn_tpu_torch.fv.integrator import integrate_residuals
    from gen_fvgn_tpu_torch.ops import launch_counts, mesh_lists, \
        plain_versions
    from test_torch_segment_csr import _ReportsCuda
    batch = batch_of("outflow")
    new, hat, old = states(batch, 1)
    lists = fv_csr.build_lists(batch)
    assert mesh_lists(batch, Config()) is None
    card = batch.replace(face_node=batch.face_node.as_subclass(_ReportsCuda))
    assert mesh_lists(card, Config()).fv is not None
    for form in (dict(conserved_form=False), dict(order="1st"),
                 dict(order="3rd")):
        assert mesh_lists(card, Config(**form)).fv is None
    calls = lambda: (integrator.FV_KERNEL_CALLS, integrator.FV_PLAIN_CALLS)
    before = calls()
    counts = launch_counts()
    _plain(new, hat, old, batch, True)
    _plain(new, hat, old, batch, True, conserved=False)
    with plain_versions():
        _plain(new, hat, old, batch, True)
    assert calls() == (before[0], before[1] + 3)
    got = integrate_residuals(new, hat, old, batch, "2nd", True, True,
                              fv_lists=lists)
    ref = _lists_path(new, hat, old, batch, True)
    assert calls() == (before[0] + 1, before[1] + 3)
    for a, r in zip(list(got[0]) + list(got[1:]), list(ref[0]) + list(ref[1:])):
        assert torch.equal(a, r)
    with pytest.raises(ValueError):
        integrate_residuals(new, hat, old, batch, "2nd", False, True,
                            fv_lists=lists)
    assert calls() == (before[0] + 1, before[1] + 3)
    after = launch_counts()
    assert {k: after[k] - counts[k] for k in after if k.startswith("fv_")} \
        == {k: 0 for k in after if k.startswith("fv_")}
    assert {"fv_lists", "fv_wlsq", "fv_face", "fv_cell", "fv_loss",
            "fv_smooth", "fv_cell_bwd", "fv_node_bwd",
            "fv_wlsq_bwd"} <= set(after)
    with pytest.raises(ValueError):
        cut = batch.replace(wlsq_S=batch.wlsq_S[..., :2, :2])
        fv_csr.residual(new, hat, old, cut, True, lists)
    with pytest.raises(TypeError):
        fv_csr.residual(new.double(), hat, old, batch, True, lists)


# ---- the card ----

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _to_card(batch):
    import dataclasses
    return batch.replace(**{f.name: getattr(batch, f.name).cuda()
                            for f in dataclasses.fields(batch)})


@functools.lru_cache(maxsize=None)
def _cells_batch():
    """The benchmark cells' batch: 8 lanes of the 201 x 201-node cavity,
    padded as the segment pool pads it, on the card."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import synthetic_case
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(batch_size=8, dataset_size=8)
    pool = EnvPool([], cfg, seed=0, engine="segment", device="cuda",
                   cases=[synthetic_case(outflow_cavity(200), **KW)])
    return pool.gather_batch(np.arange(8))


def _card_runs(batch, ncn, seed):
    """(kernels' outputs and gradients, twice; the plain CUDA chain's)."""
    from gen_fvgn_tpu_torch.ops import plain_versions
    new, hat, old = [t.cuda() for t in states(batch.replace(
        node_mask=batch.node_mask.cpu(), pos=batch.pos.cpu()), seed)]

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in (new, hat, old)]
        losses, rt, cell = fn(*ins, batch, ncn)
        g = torch.Generator(device="cuda").manual_seed(seed + 100)
        outs = list(losses) + [cell] + ([rt] if ncn else [])
        cots = [torch.randn(o.shape, generator=g, device="cuda")
                for o in outs]
        grads = torch.autograd.grad(outs, ins, cots)
        return [o.detach() for o in outs], list(grads)

    first, second = run(_lists_path), run(_lists_path)
    with plain_versions():
        plain = run(_plain)
    return first, second, plain


@pytest.mark.cuda
@pytest.mark.parametrize("ncn", [True, False], ids=["ncn", "no-ncn"])
@pytest.mark.parametrize("kind", ["mixed", "cells"])
def test_kernels_equal_plain_cuda_chain(kind, ncn):
    """Forward and backward within 1e-6 of scale (losses relative) of the
    plain CUDA chain; two runs the same bits; the lists as the stable
    sort's; one pass a launch."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import launch_counts
    batch = _cells_batch() if kind == "cells" else _to_card(batch_of(kind))
    lists = fv_csr.build_lists(batch)
    ref = fv_csr.build_lists_reference(batch)
    live = ref.ids.shape[0]
    assert torch.equal(lists.ptr, ref.ptr)
    assert torch.equal(lists.ids[:live], ref.ids)
    before = launch_counts()
    first, second, plain = _card_runs(batch, ncn, 11)
    after = launch_counts()
    fv = {k: (after[k] - before[k]) // 2 for k in after
          if k.startswith("fv_")}
    assert fv == dict(fv_lists=3, fv_wlsq=1, fv_face=1, fv_cell=1, fv_loss=1,
                      fv_smooth=int(ncn), fv_cell_bwd=1, fv_node_bwd=1,
                      fv_wlsq_bwd=1)
    for i, (a, r) in enumerate(zip(first[0], plain[0])):
        if i < 4:
            torch.testing.assert_close(a, r, rtol=1e-6, atol=0)
        else:
            assert scaled_gap(a, r) <= 1e-6, f"output {i}"
    for i, (a, r) in enumerate(zip(first[1], plain[1])):
        assert scaled_gap(a, r) <= 1e-6, f"gradient {i}"
    for a, a2 in zip(first[0] + first[1], second[0] + second[1]):
        assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
