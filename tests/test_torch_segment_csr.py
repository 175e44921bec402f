"""PyTorch port, the segment engine's GraphNet transfers on incidence lists
(`ops/segment_csr.py`, kernels in `csrc/segment_csr.cu`) against the plain
version of `ops/segment.py` (masked `segment_sum`s and `gather_rows`).

On the CPU (no card needed): the lists of a quadrilateral cavity batch, of
a mixed batch (a quadrilateral and a triangular cavity padded to one size,
so each lane has its own faces and a node up to three entries a list) and
of a bucket-tier batch hold every unmasked face once under its receiver
and once under its sender, in ascending face order, and no masked face;
the degree equals the plain two-way sum of ones; the three forms through
the lists (their plain versions, which CPU tensors take) equal the plain
version bit for bit, forward and backward, in bf16 and float32 (±0 counted
equal; `collect`'s cotangent zero on masked faces, as the nets give it);
a GnBlock on the lists equals the plain GnBlock's outputs bit for bit;
`ops.mesh_lists` gives CPU tensors no lists, and none inside
`ops.plain_versions()`, and on (what says it is) the card the incidence
lists, with the FV lists at the forms their passes cover alone.

On the card (marker `cuda`, skipped without one): the kernels against the
CPU plain version at the benchmark cells' shapes (201 x 201 nodes, batch
8, h 128 and 64), on the mixed batch and at an odd width, forward and
backward in bf16 and float32, two runs the same bits; a GnBlock and a
TransFVGN_v2 forward and backward through the kernels against the same
module on the CPU path. Run them with

    python -m pytest tests/test_torch_segment_csr.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from gen_fvgn_tpu_torch.ops import segment_csr as csr
from gen_fvgn_tpu_torch.ops.segment import gather_rows, segment_sum


# ---- batches ----

def _padded(mesh, n_pad, e_pad):
    fn = mesh["face|face_node"].astype(np.int32)
    face_node = np.zeros((2, e_pad), np.int32)
    face_node[:, :fn.shape[1]] = fn
    mask = np.zeros(e_pad, bool)
    mask[:fn.shape[1]] = True
    return face_node, mask


def _stack(meshes, n_pad, e_pad):
    pairs = [_padded(m, n_pad, e_pad) for m in meshes]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])),
            torch.from_numpy(np.stack([p[1] for p in pairs])), n_pad)


def _tier_batch():
    """A batch of one bucket tier of a segment pool of two cavities of
    different sizes (`bucket_tiers=True`)."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     cavity_tri_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net="FVGN", batch_size=2, dataset_size=4, hidden_size=32,
                 message_passing_num=1, engine="segment")
    pool = EnvPool([], cfg, seed=0, engine="segment", bucket_tiers=True,
                   device="cpu", cases=[
                       synthetic_case(cavity_quad_mesh(5), continuity=1),
                       synthetic_case(cavity_tri_mesh(12), continuity=1)])
    assert pool.n_tiers == 2
    idxs = pool.batch_indices(step_seed=1)[0]
    batch = pool.gather_batch(idxs)
    return batch.face_node, batch.face_mask, batch.pos.shape[1]


def batch_of(kind):
    """(face_node [B, 2, E], face_mask [B, E], n_nodes)."""
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     cavity_tri_mesh)
    if kind == "quad":
        m = cavity_quad_mesh(7)
        return _stack([m, m, m], 128, 128)
    if kind == "mixed":
        q, t = cavity_quad_mesh(6), cavity_tri_mesh(7)
        return _stack([q, t, q], 128, 256)
    if kind == "tier":
        return _tier_batch()
    if kind == "cells":
        m = cavity_quad_mesh(200)
        return _stack([m] * 8, m["node|pos"].shape[0],
                      m["face|face_node"].shape[1])
    raise ValueError(kind)


def _data(shape, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 4).to(dtype).to(device)


# ---- the plain version of each form (ops/segment.py) ----

def plain_nbr_sum(x, face_node, mask):
    s, r = face_node[:, 0], face_node[:, 1]
    return (segment_sum(gather_rows(x, s), r, x.shape[1], mask)
            + segment_sum(gather_rows(x, r), s, x.shape[1], mask))


def plain_inc_sum(e, face_node, mask, n_nodes):
    s, r = face_node[:, 0], face_node[:, 1]
    half_a, half_b = torch.chunk(e, 2, dim=-1)
    return (segment_sum(half_a, r, n_nodes, mask)
            + segment_sum(half_b, s, n_nodes, mask))


def plain_collect(agg, e, face_node):
    s, r = face_node[:, 0], face_node[:, 1]
    return torch.cat([gather_rows(agg, s), gather_rows(agg, r), e], dim=-1)


def _grads(fn, inputs, cot):
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*inputs)
    return out.detach(), torch.autograd.grad(out, inputs, cot)


def forms(face_node, mask, n, h, dtype, device, seed=0):
    """Each form's output and input gradients, through the lists (`inc`
    on `device`) and through the plain version (on the CPU), as pairs
    {name: ((list out, list grads), (plain out, plain grads))}."""
    b, _, e = face_node.shape
    half = h // 2
    x, ea = _data((b, n, h), dtype, seed), _data((b, e, h), dtype, seed + 1)
    gx, ge = _data((b, n, h), dtype, seed + 2), _data((b, n, half), dtype,
                                                      seed + 3)
    # the nets give collect no cotangent on masked faces
    gc = _data((b, e, 3 * h), dtype, seed + 4) * mask[..., None].to(dtype)
    inc = csr.build_incidence(face_node.to(device), mask.to(device), n)
    dev = lambda *ts: [t.to(device) for t in ts]
    cases = dict(
        nbr_sum=((lambda t: csr.nbr_sum(t, inc)), [x], gx,
                 lambda t: plain_nbr_sum(t, face_node, mask)),
        inc_sum=((lambda t: csr.inc_sum(t, inc, 0, half, half)), [ea], ge,
                 lambda t: plain_inc_sum(t, face_node, mask, n)),
        collect=((lambda a, t: csr.collect(a, t, inc)), [x, ea], gc,
                 lambda a, t: plain_collect(a, t, face_node)))
    out = {}
    for name, (fn, ins, cot, plain) in cases.items():
        got = _grads(fn, dev(*ins), cot.to(device))
        out[name] = ((got[0].cpu(), [g.cpu() for g in got[1]]),
                     _grads(plain, ins, cot))
    return out


def assert_same(got, ref, what):
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    # torch.equal: +0 == -0
    bad = (got != ref).nonzero()
    assert bad.shape[0] == 0, (f"{what}: {bad.shape[0]} values differ, the "
                               f"first at {bad[0].tolist()}: "
                               f"{got[tuple(bad[0])]} vs {ref[tuple(bad[0])]}")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _twoway_ones(face_node, mask, n):
    from gen_fvgn_tpu_torch.models.gn import _twoway_sum
    ones = torch.ones(face_node.shape[:1] + face_node.shape[2:] + (1,))
    return _twoway_sum(ones, ones, face_node, n, mask)


# ---- CPU ----

@pytest.mark.parametrize("kind", ["quad", "mixed", "tier"])
def test_incidence_lists(kind):
    """Every unmasked face once under its receiver and once under its
    sender, with the neighbour's node row; ascending face order within each
    list; no masked face; the degree is the plain two-way sum of ones."""
    face_node, mask, n = batch_of(kind)
    b, _, e = face_node.shape
    inc = csr.build_incidence(face_node, mask, n)
    assert inc.shape == (b, n, e)
    fn = face_node.long()
    for ptr, faces, nbr, own, other in (
            (inc.recv_ptr, inc.recv_face, inc.recv_nbr, 1, 0),
            (inc.send_ptr, inc.send_face, inc.send_nbr, 0, 1)):
        assert ptr.dtype == faces.dtype == nbr.dtype == torch.int32
        total = int(ptr[-1])
        assert total == int(mask.sum()) and int(ptr[0]) == 0
        assert bool((torch.diff(ptr) >= 0).all())
        rows = torch.repeat_interleave(torch.arange(b * n), torch.diff(ptr))
        f = faces[:total].long()
        assert sorted(f.tolist()) == mask.reshape(-1).nonzero()[:, 0].tolist()
        fb, fl = f // e, f % e
        assert bool((fb * n + fn[fb, own, fl] == rows).all())
        assert bool((nbr[:total].long() == fb * n + fn[fb, other, fl]).all())
        same_row = rows[1:] == rows[:-1]
        assert bool((f[1:][same_row] > f[:-1][same_row]).all())
    assert bool((inc.face_s.long().reshape(b, e)
                 == fn[:, 0] + n * torch.arange(b)[:, None]).all())
    assert bool((inc.face_r.long().reshape(b, e)
                 == fn[:, 1] + n * torch.arange(b)[:, None]).all())
    assert torch.equal(inc.deg, _twoway_ones(face_node, mask, n))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["quad", "mixed", "tier"])
def test_forms_through_lists_equal_plain_version(kind, dtype):
    """(a) nbr_sum, (b) inc_sum, (c) collect through the lists on the CPU
    (their plain versions) against ops/segment.py, forward and backward:
    equal bits (±0 equal). The mixed and tier batches have lists of three."""
    face_node, mask, n = batch_of(kind)
    for name, ((out, grads), (ref, rgrads)) in forms(
            face_node, mask, n, 32, dtype, "cpu").items():
        assert_same(out, ref, f"{name} forward")
        for i, (g, r) in enumerate(zip(grads, rgrads)):
            assert_same(g, r, f"{name} gradient {i}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_faces_is_the_transpose_of_inc_sum(dtype):
    """(c) into two windows with masked faces zero: the plain inc_sum's
    vector-Jacobian product, bit for bit, and back (its own backward)."""
    face_node, mask, n = batch_of("mixed")
    b, _, e = face_node.shape
    inc = csr.build_incidence(face_node, mask, n)
    y = _data((b, n, 16), dtype, 5)
    ea = _data((b, e, 32), dtype, 6)
    ref, = _grads(lambda t: plain_inc_sum(t, face_node, mask, n), [ea], y)[1]
    out, (gy,) = _grads(lambda t: csr.gather_faces(t, inc, 0, 16, 32), [y],
                        ea)
    assert_same(out, ref, "gather_faces")
    assert_same(gy, plain_inc_sum(ea, face_node, mask, n), "its backward")
    with pytest.raises(ValueError):
        csr.inc_sum(ea, inc, 0, 8, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_block_on_lists_equals_plain_block(dtype):
    """A GnBlock with the lists (CPU: the forms' plain versions) and without
    (ops/segment.py): the same outputs, bit for bit; the gradients add the
    same terms in another order (autograd sums a tensor's uses as they
    arrive), within 2 bf16 ulps of each gradient's scale or 1e-6 of it in
    float32. Measured: bf16 1 ulp, float32 1.1e-7."""
    from gen_fvgn_tpu_torch.models.gn import GnBlock
    face_node, mask, n = batch_of("mixed")
    b, _, e = face_node.shape
    block = GnBlock(32, dtype if dtype == torch.bfloat16 else None,
                    torch.Generator().manual_seed(0))
    x, ea = _data((b, n, 32), dtype, 7), _data((b, e, 32), dtype, 8)
    gx = _data((b, n, 32), dtype, 9)
    ge = _data((b, e, 32), dtype, 10) * mask[..., None].to(dtype)
    inc = csr.build_incidence(face_node, mask, n)
    runs = []
    for lists in (inc, None):
        xi = x.clone().requires_grad_(True)
        ei = ea.clone().requires_grad_(True)
        no, eo = block(xi, ei, face_node, mask, lists)
        grads = torch.autograd.grad(
            [no, eo], [xi, ei] + list(block.parameters()), [gx, ge])
        runs.append((no.detach(), eo.detach(), grads))
    assert_same(runs[0][0], runs[1][0], "node output")
    assert_same(runs[0][1], runs[1][1], "edge output")
    for g, r in zip(runs[0][2], runs[1][2]):
        r32 = r.float()
        scale = float(r32.abs().max())
        tol = (2.0 ** (np.floor(np.log2(scale)) - 6) if dtype == torch.bfloat16
               else 1e-6 * scale)
        assert float((g.float() - r32).abs().max()) <= tol


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that says it is on the card: `ops.mesh_lists`'s
    device test passes, and its builders run on the CPU."""
    is_cuda = True


def _sample_batch():
    """A stacked MeshSample of CPU tensors (a segment pool's batch)."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    cfg = Config(net="FVGN", batch_size=2, dataset_size=2, hidden_size=32,
                 message_passing_num=1, engine="segment")
    pool = EnvPool([], cfg, seed=0, engine="segment", device="cpu",
                   cases=[synthetic_case(cavity_quad_mesh(5), continuity=1)])
    return pool.gather_batch(np.arange(2))


def test_incidence_for_takes_the_plain_version_on_the_cpu():
    """`ops.mesh_lists`, the segment engine's one choice between its
    kernels and their plain versions: None for CPU tensors and inside
    `ops.plain_versions()`, at every form; on (what says it is) the card,
    the incidence lists of `build_incidence` and the FV lists of
    `fv_csr.build_lists` at order "2nd" in the conserved form, no FV lists
    at any other form."""
    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.ops import fv_csr, mesh_lists, plain_versions
    batch = _sample_batch()
    forms = [Config(), Config(conserved_form=False), Config(order="3rd")]
    for cfg in forms:
        assert mesh_lists(batch, cfg) is None
    card = batch.replace(face_node=batch.face_node.as_subclass(_ReportsCuda))
    with plain_versions():
        for cfg in forms:
            assert mesh_lists(card, cfg) is None
    want_inc = csr.build_incidence(batch.face_node, batch.face_mask,
                                   batch.uvp.shape[1])
    want_fv = fv_csr.build_lists(batch)
    for cfg in forms:
        got = mesh_lists(card, cfg)
        for a, b in zip(got.inc, want_inc):
            assert torch.equal(a, b)
        if cfg.order == "2nd" and cfg.conserved_form:
            assert torch.equal(got.fv.ptr, want_fv.ptr)
            assert torch.equal(got.fv.ids, want_fv.ids)
            assert got.fv.sizes == want_fv.sizes
        else:
            assert got.fv is None


# ---- the card ----

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,h", [("cells", 128), ("cells", 64),
                                    ("mixed", 128), ("mixed", 40),
                                    ("quad", 24)])
def test_kernels_equal_cpu_plain_version(kind, h, dtype):
    """The three kernels, forward and backward, against ops/segment.py on
    the CPU: equal bits (±0 equal); h 24 and 40 take the kernels' scalar
    and vector paths at widths that are no multiple of 32; two runs give
    the same bits."""
    _need_card()
    face_node, mask, n = batch_of(kind)
    before = dict(csr.__dict__)
    first = forms(face_node, mask, n, h, dtype, "cuda")
    launched = {k: getattr(csr, k) - before[k] for k in (
        "LAUNCHES_NBR_SUM", "LAUNCHES_INC_SUM", "LAUNCHES_COLLECT")}
    # forward and backward: nbr_sum 2, inc_sum (forward, collect's
    # backward) 2, seg_collect (collect, inc_sum's backward) 2
    assert launched == dict(LAUNCHES_NBR_SUM=2, LAUNCHES_INC_SUM=2,
                            LAUNCHES_COLLECT=2)
    second = forms(face_node, mask, n, h, dtype, "cuda")
    for name, ((out, grads), (ref, rgrads)) in first.items():
        assert_same(out, ref, f"{name} forward")
        for i, (g, r) in enumerate(zip(grads, rgrads)):
            assert_same(g, r, f"{name} gradient {i}")
        (out2, grads2), _ = second[name]
        for a, a2 in zip([out] + grads, [out2] + grads2):
            assert torch.equal(_bits(a), _bits(a2)), f"{name}: two runs"


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    """Types, shapes and widths the kernels do not take raise; so does a
    GraphNet block on CUDA tensors without its lists, outside
    `ops.plain_versions()` (there is no fallback on the card)."""
    from gen_fvgn_tpu_torch.models.gn import EdgeBlock, NodeBlock
    from gen_fvgn_tpu_torch.ops import plain_versions
    _need_card()
    face_node, mask, n = batch_of("quad")
    inc = csr.build_incidence(face_node.cuda(), mask.cuda(), n)
    b, _, e = face_node.shape
    args = (torch.zeros(b, n, 16, device="cuda"),
            torch.zeros(b, e, 16, device="cuda"), face_node.cuda(),
            mask.cuda())
    for block in (EdgeBlock(16).cuda(), NodeBlock(16).cuda()):
        with pytest.raises(RuntimeError):
            block(*args)
        with plain_versions():
            block(*args)
    with pytest.raises(TypeError):
        csr.nbr_sum(torch.zeros(b, n, 8, device="cuda",
                                dtype=torch.float16), inc)
    with pytest.raises(ValueError):
        csr.nbr_sum(torch.zeros(b, n + 1, 8, device="cuda"), inc)
    with pytest.raises(ValueError):
        csr.collect(torch.zeros(b, n, 8, device="cuda"),
                    torch.zeros(b, e, 16, device="cuda"), inc)


def _module_runs(module, args, cots, device, inc=None):
    """The module's outputs and gradients on `device`, on the incidence
    lists `inc` where given (the plain versions where not)."""
    module = module.to(device)
    ins = [a.to(device).requires_grad_(a.is_floating_point()) for a in args]
    outs = module(*ins, inc)
    outs = outs if isinstance(outs, tuple) else (outs,)
    params = list(module.parameters())
    grads = torch.autograd.grad(
        outs, [i for i in ins if i.requires_grad] + params,
        [c.to(device) for c in cots])
    return [o.detach().float().cpu() for o in outs], \
        [g.float().cpu() for g in grads]


def _ulps(ref, n):
    return n * 2.0 ** (np.floor(np.log2(float(ref.abs().max()))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["GnBlock", "TransFVGN_v2"])
def test_gn_block_and_net_through_kernels_match_cpu_path(net):
    """One segment GnBlock (h 128, bf16) and one TransFVGN_v2 (Config
    defaults, bf16) on the mixed batch through the kernels against the same
    module on the CPU path: outputs within the bf16 limits of
    tests/test_torch_segment.py (GnBlock 3 ulps of the output scale;
    TransFVGN_v2 12, median 1), the gradients within 2e-2 of their norm
    (chip_smoke.py's card-vs-plain limit: the card runs K2/K3 where the
    CPU runs their plain versions); no plain GnBlock transfer on the card."""
    _need_card()
    import copy

    from gen_fvgn_tpu_torch.config import Config
    from gen_fvgn_tpu_torch.models.gn import GnBlock
    from gen_fvgn_tpu_torch.models.simulator import make_simulator
    face_node, mask, n = batch_of("mixed")
    b, _, e = face_node.shape
    bf = torch.bfloat16
    if net == "GnBlock":
        module = GnBlock(128, bf, torch.Generator().manual_seed(0))
        args = [_data((b, n, 128), bf, 1), _data((b, e, 128), bf, 2),
                face_node, mask]
        cots = [_data((b, n, 128), bf, 3),
                _data((b, e, 128), bf, 4) * mask[..., None].to(bf)]
        limits = [(3, None), (3, None)]
    else:
        cfg = Config(net="TransFVGN_v2", engine="segment")
        module = make_simulator(cfg, device="cpu", seed=0)
        node_mask = torch.zeros(b, n, dtype=torch.bool)
        for i in range(b):
            node_mask[i, :int(face_node[i].max()) + 1] = True
        args = [_data((b, n, cfg.node_input_size), torch.float32, 1),
                _data((b, e, cfg.edge_input_size), torch.float32, 2),
                face_node, node_mask, mask]
        cots = [_data((b, n, cfg.node_output_size), bf, 3)]
        limits = [(12, 1)]
    inc = csr.build_incidence(face_node.cuda(), mask.cuda(), n)
    card = _module_runs(copy.deepcopy(module), args, cots, "cuda", inc)
    cpu = _module_runs(module, args, cots, "cpu")
    for got, ref, (n_max, n_med) in zip(card[0], cpu[0], limits):
        gap = (got - ref).abs()
        assert float(gap.max()) <= _ulps(ref, n_max)
        if n_med is not None:
            assert float(gap.median()) <= _ulps(ref, n_med)
    num = sum(float(((g - r) ** 2).sum()) for g, r in zip(*[card[1], cpu[1]]))
    den = sum(float((r ** 2).sum()) for r in cpu[1])
    assert (num / den) ** 0.5 <= 2e-2
