"""PyTorch port, the CUDA kernels themselves against their plain PyTorch
versions, on the card. A CUDA kernel has no interpret mode, so these tests
need an NVIDIA card and nvcc and skip elsewhere (they decide that inside the
test, never while the module is imported). Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q

`chip_smoke.py` makes the same comparisons at the main path's full shapes;
these cover the edges: ragged row counts, every operand/output type of the
sparse apply (K1 also on column windows of wider tensors, at F 64 to 256,
B = 1, float32, and in the windowed composed node aggregation forward and
backward) and of the paired applies (K8, K9: B = 1, empty rows, float32
operands, H = 48 to 256, rows of one to forty non-zeros in either
operator, unaligned operands; a row whose float32 sum lies next to a bf16
rounding midpoint), unbatched operands, all-zero and partial node masks,
shared and per-lane masks, the fused MLP kernels (K2, K3, K4f, K4b) at
hidden widths 128 and 256 (and 384 for the 32-row tiles) in every form the
nets use, the pre-LN branch (K5f, K5b) at C 128 to 2048 and the slice pool
(K6, K7) at seventeen (C, H, G) shapes up to C 2048, with lanes of one row, ragged lanes
and ragged last tiles, the bitwise repeatability of the backward kernels
and the slice pool, the shapes each kernel refuses, the kernels' size
queries against the Python predicates, K2/K3 at the segment engine's part
forms (one 3h-wide part, one 2h-wide part; the node MLP's 192-wide part
through the padding wrapper) on row counts that are odd multiples of 128,
and one segment train step's gradients against the plain versions."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _ulps(ref, n=2):
    scale = float(ref.float().abs().max())
    return n * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _op(dtype, n_out=1000, n_in=777, seed=0):
    from gen_fvgn_tpu_torch.ops.blocksparse import build_csr_op
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_out - 50), 6)
    cols = rng.integers(0, n_in, rows.shape[0])
    vals = (rng.integers(1, 4, rows.shape[0]) if dtype == "bfloat16"
            else rng.normal(size=rows.shape[0])).astype(np.float32)
    return build_csr_op(rows, cols, vals, n_out, n_in, dtype).to("cuda")


@pytest.mark.parametrize("op_dtype,x_dtype,out_dtype", [
    ("bfloat16", torch.bfloat16, torch.bfloat16),
    ("bfloat16", torch.float32, torch.float32),
    ("float32", torch.float32, torch.float32),
    ("float32", torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape", [(3, 128), (1, 256), (None, 128)])
def test_spmm_kernel_matches_plain_version(op_dtype, x_dtype, out_dtype,
                                           shape):
    _need_card()
    from gen_fvgn_tpu_torch.ops import spmm as mod
    op = _op(op_dtype)
    b, f = shape
    size = (op.n_in, f) if b is None else (b, op.n_in, f)
    x = torch.randn(*size, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)
                    ).to(x_dtype)
    before = mod.LAUNCHES
    out = mod.spmm(op, x)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    ref = mod.spmm_reference(op, x)
    assert out.dtype == ref.dtype == out_dtype and out.shape == ref.shape
    tol = 2 ** -8 if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=1e-5)
    assert bool((out[..., op.n_out - 50:, :] == 0).all())


@pytest.mark.parametrize("op_dtype,x_dtype", [
    ("bfloat16", torch.bfloat16), ("bfloat16", torch.float32),
    ("float32", torch.float32)])
@pytest.mark.parametrize("b", [1, 3, None])
@pytest.mark.parametrize("f,width,c0", [(64, 128, 0), (64, 128, 64),
                                        (128, 256, 128), (64, 64, 0),
                                        (192, 256, 64)])
def test_spmm_kernel_takes_column_windows(op_dtype, x_dtype, b, f, width,
                                          c0):
    """K1 on columns c0 .. c0 + f of a wider operand, written into the
    same columns of a wider output, against its plain version on the
    window: one bf16 rounding (bf16 output) or the order of float32 sums;
    the columns around the window are left as they were; two runs give the
    same bits."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import spmm as mod
    from gen_fvgn_tpu_torch.ops.blocksparse import _out_dtype
    op = _op(op_dtype)
    lead = () if b is None else (b,)
    g = torch.Generator("cuda").manual_seed(f + width + c0)
    x = torch.randn(*lead, op.n_in, width, device="cuda",
                    generator=g).to(x_dtype)
    win = x[..., c0:c0 + f]
    dt = _out_dtype(op, win)
    out = torch.full((*lead, op.n_out, width), 7.0, device="cuda", dtype=dt)
    before = mod.LAUNCHES
    mod.spmm(op, win, out=out[..., c0:c0 + f])
    again = mod.spmm(op, win)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 2
    ref = mod.spmm_reference(op, win)
    got = out[..., c0:c0 + f]
    assert torch.equal(got, again)
    tol = 2 ** -8 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=1e-5)
    assert bool((got[..., op.n_out - 50:, :] == 0).all())
    rest = torch.cat([out[..., :c0], out[..., c0 + f:]], dim=-1)
    assert bool((rest == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_node_agg_kernel_matches_plain_version(dtype):
    """The windowed composed node aggregation (two K1 launches forward, two
    backward into the halves of one gradient) against the same under the
    plain versions on the card: within one bf16 rounding (float32 sums in
    another order), with the launches of the full-width composition."""
    _need_card()
    from types import SimpleNamespace
    from gen_fvgn_tpu_torch.ops import plain_versions, spmm
    from gen_fvgn_tpu_torch.ops.blocksparse import apply_node_agg, build_linop
    rng = np.random.default_rng(5)
    n_nodes, n_edges = 1000, 1800
    lin = {}
    for name in ("nbr_r", "nbr_s"):
        rows = np.repeat(np.arange(n_nodes - 50), 6)
        cols = rng.integers(0, n_edges, rows.shape[0])
        vals = rng.integers(1, 4, rows.shape[0]).astype(np.float32)
        lin[name] = build_linop(rows, cols, vals, n_nodes, n_edges,
                                "bfloat16").to("cuda")
    ops = SimpleNamespace(**lin)
    g = torch.Generator("cuda").manual_seed(3)
    e0 = torch.randn(3, n_edges, 128, device="cuda", generator=g).to(dtype)
    cot = torch.randn(3, n_nodes, 64, device="cuda", generator=g)
    outs, grads = [], []
    for plain in (False, True):
        e = e0.clone().requires_grad_(True)
        before = spmm.LAUNCHES
        if plain:
            with plain_versions():
                y = apply_node_agg(ops, e)
                y.backward(cot.to(y.dtype))
        else:
            y = apply_node_agg(ops, e)
            y.backward(cot.to(y.dtype))
            torch.cuda.synchronize()
            assert spmm.LAUNCHES == before + 4
        outs.append(y.detach())
        grads.append(e.grad)
    for got, ref in zip((outs[0], grads[0]), (outs[1], grads[1])):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                                   atol=1e-5)


def test_spmm_kernel_refuses_what_it_does_not_take():
    _need_card()
    from gen_fvgn_tpu_torch.ops import spmm as mod
    op = _op("bfloat16")
    with pytest.raises(ValueError):
        mod.spmm(op, torch.zeros(op.n_in, 96, device="cuda"))
    with pytest.raises(TypeError):
        mod.spmm(op, torch.zeros(op.n_in, 128, device="cuda",
                                 dtype=torch.float16))


@pytest.mark.parametrize("op_dtype,x_dtype", [
    ("bfloat16", torch.bfloat16), ("bfloat16", torch.float32),
    ("float32", torch.float32), ("float32", torch.bfloat16)])
@pytest.mark.parametrize("b", [1, 3, None])
@pytest.mark.parametrize("h", [64, 128, 48])
@pytest.mark.parametrize("kind", ["pair_sum", "pair_transpose"])
def test_pair_kernels_match_plain_versions(kind, h, b, op_dtype, x_dtype):
    """K8 and K9 on two operators whose last 50 rows are empty: every type
    pair of the rule, B = 1 and an unbatched operand, H = 64 (the node
    pair), 128 (the gather pair) and 48 (one feature a lane). A bf16
    output is one rounding from the plain version, a float32 one differs
    by the order of float32 sums."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import pair_spmm as mod
    a, bop = _op(op_dtype, seed=0), _op(op_dtype, seed=1)
    width = 2 * h if kind == "pair_sum" else h
    size = (a.n_in, width) if b is None else (b, a.n_in, width)
    x = torch.randn(*size, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(h)
                    ).to(x_dtype)
    counter = "LAUNCHES_" + kind.upper()
    before = getattr(mod, counter)
    out = getattr(mod, kind)(a, bop, x)
    again = getattr(mod, kind)(a, bop, x)
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 2
    ref = getattr(mod, kind + "_reference")(a, bop, x)
    bf_out = op_dtype == "bfloat16" and x_dtype == torch.bfloat16
    assert out.dtype == ref.dtype == (torch.bfloat16 if bf_out
                                      else torch.float32)
    assert out.shape == ref.shape and torch.equal(out, again)
    assert out.shape[-1] == (h if kind == "pair_sum" else 2 * h)
    tol = 2 ** -8 if bf_out else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=1e-5)
    assert bool((out[..., a.n_out - 50:, :] == 0).all())


def test_pair_kernels_out_dtype_and_refusals():
    """The node pair's named output type (bf16 from a float32 operand cast
    by bf16-stored operators, as JAX), and what the kernels do not take."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import pair_spmm as mod
    a, bop = _op("bfloat16", seed=0), _op("bfloat16", seed=1)
    y = torch.randn(2, a.n_in, 128, device="cuda")
    out = mod.pair_sum(a, bop, y, out_dtype=torch.bfloat16)
    ref = mod.pair_sum_reference(a, bop, y, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -8,
                               atol=1e-5)
    with pytest.raises(ValueError):
        mod.pair_sum(a, bop, y[..., :127].contiguous())       # odd width
    with pytest.raises(TypeError):
        mod.pair_transpose(a, bop, y.to(torch.float16))
    with pytest.raises(ValueError):
        mod.pair_sum(a, _op("bfloat16", n_out=999, seed=1), y)


def test_pair_sum_at_a_bf16_rounding_midpoint():
    """K8 where a float32 sum in one order lands on a bf16 rounding midpoint
    and in another does not (as found on the card: the exact sum
    -1.808593599, K8 -1.8125, its plain version -1.8046875). Row 0 sums
    1024 + 2^-23 - 1024 through A and -1.8046875 - 2^-8 through B: exactly
    -1.80859375 + 2^-23, one float32 step above the midpoint -1.80859375;
    a sum that holds 1024 when 2^-23 arrives loses it and rounds the
    midpoint to even. The kernel and the plain version may differ there by
    one bf16 ulp of the output, and no more; both lie within one ulp of the
    exact sum."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import pair_spmm as mod
    from gen_fvgn_tpu_torch.ops.blocksparse import build_csr_op
    h, n_in = 64, 8
    ones = lambda k: np.ones(k, np.float32)
    a = build_csr_op(np.zeros(3, np.int64), np.array([0, 1, 2]), ones(3), 2,
                     n_in, "bfloat16").to("cuda")
    b = build_csr_op(np.zeros(2, np.int64), np.array([3, 4]), ones(2), 2,
                     n_in, "bfloat16").to("cuda")
    y = torch.zeros(1, n_in, 2 * h)
    y[0, 0, :h], y[0, 1, :h], y[0, 2, :h] = 1024.0, 2.0 ** -23, -1024.0
    y[0, 3, h:], y[0, 4, h:] = -1.8046875, -(2.0 ** -8)
    y = y.to("cuda").to(torch.bfloat16)
    exact = -1.80859375 + 2.0 ** -23
    out = mod.pair_sum(a, b, y).float()[0, 0]
    ref = mod.pair_sum_reference(a, b, y).float()[0, 0]
    ulp = 2.0 ** (np.floor(np.log2(abs(exact))) - 7)
    assert float((out - ref).abs().max()) <= ulp
    for t in (out, ref):
        assert float((t - exact).abs().max()) <= ulp


def _pair_ops(op_dtype, n_out=300, n_in=257, seed=3):
    """A and B of the row-for-all-lanes tests: rows 0..99 one non-zero each
    (the gather pair), 100..199 three and two, row 200 forty in A alone,
    row 201 twenty in A and twenty-five in B (the list crosses from A to B
    inside a 32-index load and goes beyond it), row 202 thirty-three in B
    alone, 203..249 two and two, 250..299 empty in both. Integer weights
    for bf16-stored operators (as the structural ones), normal otherwise."""
    from gen_fvgn_tpu_torch.ops.blocksparse import build_csr_op
    rng = np.random.default_rng(seed)
    counts = {"a": [1] * 100 + [3] * 100 + [40, 20, 0] + [2] * 47,
              "b": [1] * 100 + [2] * 100 + [0, 25, 33] + [2] * 47}
    ops = []
    for k in ("a", "b"):
        rows = np.repeat(np.arange(250), counts[k])
        cols = np.concatenate([rng.choice(n_in, c, replace=False)
                               for c in counts[k]])
        vals = (rng.choice([-3, -2, -1, 1, 2, 3], rows.shape[0])
                if op_dtype == "bfloat16"
                else rng.normal(size=rows.shape[0])).astype(np.float32)
        ops.append(build_csr_op(rows, cols, vals, n_out, n_in,
                                op_dtype).to("cuda"))
    return ops


@pytest.mark.parametrize("op_dtype,x_dtype", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32),
    ("bfloat16", torch.float32)])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("h", [48, 64, 128, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_pair_sum_rows_for_all_lanes(h, b, op_dtype, x_dtype, aligned):
    """K8, a warp a row for all batch lanes, against its plain version:
    H 48 to 256, B 1, 3 and 8, rows beyond one 32-index load (in one
    operator, and across A and B), empty rows exactly zero, two runs the
    same bits. `aligned` False hands it an operand 2 or 4 bytes off a
    16-byte boundary, which it reads in narrower vectors. Tolerance: a bf16
    output within one bf16 ulp of each element (the float32 sums run in
    another order: where the exact sum lies next to a rounding midpoint one
    order rounds up, the other down), a float32 one 1e-5."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import pair_spmm as mod
    a, bop = _pair_ops(op_dtype)
    g = torch.Generator("cuda").manual_seed(h + b)
    y = torch.randn(b, a.n_in, 2 * h, device="cuda", generator=g
                    ).to(x_dtype)
    if not aligned:
        flat = torch.empty(y.numel() + 1, device="cuda", dtype=x_dtype)
        y = flat[1:].view(y.shape).copy_(y)
        assert y.data_ptr() % 16 != 0
    before = mod.LAUNCHES_PAIR_SUM
    out = mod.pair_sum(a, bop, y)
    again = mod.pair_sum(a, bop, y)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_PAIR_SUM == before + 2
    ref = mod.pair_sum_reference(a, bop, y)
    assert out.dtype == ref.dtype and out.shape == ref.shape == (b, 300, h)
    assert torch.equal(out, again)
    got, want = out.float(), ref.float()
    if out.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(
            2.0 ** -100))) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-5).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool((out[:, 250:] == 0).all())
    assert bool((out[:, 200:203] != 0).any(dim=-1).all())


@pytest.mark.parametrize("op_dtype,x_dtype", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32),
    ("bfloat16", torch.float32)])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("h", [48, 64, 128, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_pair_transpose_rows_for_all_lanes(h, b, op_dtype, x_dtype, aligned):
    """K9, a warp a row [A row | B row] for all batch lanes, against its
    plain version on the operators of `test_pair_sum_rows_for_all_lanes`:
    rows of one non-zero in each operator, forty in A alone (its B half
    exactly zero), twenty + twenty-five (the list crosses from A to B
    inside a 32-index load), thirty-three in B alone (its A half exactly
    zero), empty rows exactly zero, two runs the same bits. `aligned` False
    hands it an operand 2 or 4 bytes off a 16-byte boundary, which it reads
    in narrower vectors without a copy. Tolerance: a bf16 output within one
    bf16 ulp of each element, a float32 one 1e-5."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import pair_spmm as mod
    a, bop = _pair_ops(op_dtype)
    gen = torch.Generator("cuda").manual_seed(h + b + 1)
    g = torch.randn(b, a.n_in, h, device="cuda", generator=gen).to(x_dtype)
    if not aligned:
        flat = torch.empty(g.numel() + 1, device="cuda", dtype=x_dtype)
        g = flat[1:].view(g.shape).copy_(g)
        assert g.data_ptr() % 16 != 0
    before = mod.LAUNCHES_PAIR_TRANSPOSE
    out = mod.pair_transpose(a, bop, g)
    again = mod.pair_transpose(a, bop, g)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_PAIR_TRANSPOSE == before + 2
    ref = mod.pair_transpose_reference(a, bop, g)
    assert out.dtype == ref.dtype and out.shape == ref.shape == (b, 300, 2 * h)
    assert torch.equal(out, again)
    got, want = out.float(), ref.float()
    if out.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(
            2.0 ** -100))) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-5).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool((out[:, 250:] == 0).all())
    assert bool((out[:, 200, h:] == 0).all())
    assert bool((out[:, 202, :h] == 0).all())
    assert bool((out[:, 200, :h] != 0).any() and (out[:, 201] != 0).any()
                and (out[:, 202, h:] != 0).any())


def _mlp_args(m, widths, has_pre, d_out, seed, h=128):
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    bf = torch.bfloat16
    parts = [rnd(m, k).to(bf) for k in widths]
    w1s = [(rnd(k, h) / max(sum(widths), 1) ** 0.5).to(bf) for k in widths]
    pres = (rnd(m, h).to(bf),) if has_pre else ()
    return (parts, w1s, 0.1 * rnd(h), (rnd(h, h) / h ** 0.5).to(bf),
            0.1 * rnd(h), (rnd(h, d_out) / h ** 0.5).to(bf),
            0.1 * rnd(d_out), 1 + 0.1 * rnd(d_out), 0.1 * rnd(d_out), pres)


# the part widths of each form in units of the hidden width h: the
# encoders' pres-only form, the edge MLP, the node MLP, two full parts
_FORMS = [([], True, None, False), ([1], True, 0, True),
          ([0.5, 1], False, 1, False), ([1, 1], True, None, False)]


def _widths(units, h):
    return [int(u * h) for u in units]


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("m", [1, 63, 64, 1000, 8 * 1337])
@pytest.mark.parametrize("units,has_pre,res_idx,res_dual", _FORMS)
def test_fused_mlp_ln_kernel_matches_plain_version(m, units, has_pre,
                                                   res_idx, res_dual, h):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    args = _mlp_args(m, _widths(units, h), has_pre, h, seed=m, h=h)
    before = mod.LAUNCHES_LN
    outs = mod.fused_mlp_ln(*args, res_idx=res_idx, res_dual=res_dual)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_LN == before + 1
    refs = mod.fused_mlp_ln_reference(*args, res_idx=res_idx,
                                      res_dual=res_dual)
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    assert len(outs) == len(refs) == (2 if res_dual else 1)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        torch.testing.assert_close(o.float(), r.float(), rtol=0,
                                   atol=_ulps(r))


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("m", [1, 65, 8 * 1337])
@pytest.mark.parametrize("d_out", [3, 16])
def test_fused_mlp_noln_kernel_matches_plain_version(m, d_out, h):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    parts, w1s, b1, w2, b2, w3, b3, _, _, _ = _mlp_args(
        m, [h], False, d_out, seed=m + d_out, h=h)
    before = mod.LAUNCHES_NOLN
    out = mod.fused_mlp_noln(parts[0], w1s[0], b1, w2, b2, w3, b3)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_NOLN == before + 1
    ref = mod.fused_mlp_noln_reference(parts[0], w1s[0], b1, w2, b2, w3, b3)
    assert tuple(out.shape) == (m, d_out) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_ulps(ref))


def test_fused_mlp_kernel_refuses_what_it_does_not_take():
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    args = list(_mlp_args(64, [128], False, 128, seed=0))
    args[0] = [args[0][0].float()]                      # float32 part
    with pytest.raises(ValueError):
        mod.fused_mlp_ln(*args)
    args = list(_mlp_args(64, [48], False, 128, seed=0))    # width % 16
    args[0] = [torch.zeros(64, 40, device="cuda", dtype=torch.bfloat16)]
    with pytest.raises(NotImplementedError):
        mod.fused_mlp_ln(*args)
    args = list(_mlp_args(64, [136], False, 256, seed=0, h=256))
    with pytest.raises(NotImplementedError):                # 136 > 128
        mod.fused_mlp_ln(*args)
    args = list(_mlp_args(64, [192], False, 192, seed=0, h=192))
    with pytest.raises(NotImplementedError):                # H % 128
        mod.fused_mlp_ln(*args)
    with pytest.raises(NotImplementedError):                # no room
        mod.fused_mlp_ln(*_mlp_args(64, [4096, 4096], False, 1024, seed=0,
                                    h=1024))


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_fused_mlp_kernels_at_hidden_384(direction):
    """A hidden width whose tiles take 32 rows (three 128-column passes do
    not fit the 64-row tile's shared memory): the edge MLP's form."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    h, m = 384, 1000
    args = _mlp_args(m, [h], True, h, seed=7, h=h)
    if direction == "forward":
        outs = mod.fused_mlp_ln(*args, res_idx=0, res_dual=True)
        refs = mod.fused_mlp_ln_reference(*args, res_idx=0, res_dual=True)
        torch.cuda.synchronize()
        for o, r in zip(outs, refs):
            torch.testing.assert_close(o.float(), r.float(), rtol=0,
                                       atol=_ulps(r))
        return
    g = torch.Generator("cuda").manual_seed(7)
    douts = [torch.randn(m, h, device="cuda", generator=g).to(torch.bfloat16)
             for _ in range(2)]
    bargs = (*args[:8], args[9], douts, 0, True, 2)
    got, again = mod.fused_mlp_ln_bwd(*bargs), mod.fused_mlp_ln_bwd(*bargs)
    torch.cuda.synchronize()
    assert _grads_equal(got, again)
    ref = mod.fused_mlp_ln_bwd_reference(*bargs)
    for name in got._fields:
        a, r = getattr(got, name), getattr(ref, name)
        for i, (x, y) in enumerate(zip(a if isinstance(a, tuple) else (a,),
                                       r if isinstance(r, tuple) else (r,))):
            _close(x, y, f"{name}[{i}]")


def _premlp_args(m, seed, c=128):
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    bf = torch.bfloat16
    return ((2 * rnd(m, c) + 0.5).to(bf), 1 + 0.1 * rnd(c),
            0.1 * rnd(c), (rnd(c, 2 * c) / c ** 0.5).to(bf),
            0.1 * rnd(2 * c), (rnd(2 * c, c) / (2 * c) ** 0.5).to(bf),
            0.1 * rnd(c))


# every width the pre-LN branch's kernels take (hidden width 2C); at C = 128
# the forward is the strip kernel and the backward the block row tiles,
# every wider C runs as passes through device memory
_PREMLP_C = [128, 256, 384, 512, 640, 768, 896, 1024, 1152, 2048]
_PREMLP_M = [(128, m) for m in (1, 63, 64, 65, 1000, 8 * 1251)] + [
    (c, m) for c in _PREMLP_C[1:] for m in (1, 65, 1000)]


@pytest.mark.parametrize("c,m", _PREMLP_M)
def test_fused_premlp_res_kernel_matches_plain_version(c, m):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    args = _premlp_args(m, seed=m + c - 128, c=c)
    before = mod.LAUNCHES_PREMLP
    out = mod.fused_premlp_res(*args)
    again = mod.fused_premlp_res(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_PREMLP == before + 2
    assert torch.equal(out, again)
    ref = mod.fused_premlp_res_reference(*args)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (m, c)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_ulps(ref))


# what the pre-LN kernels refuse, as the JAX package does not fuse it: a
# width that is no multiple of 128, a hidden width other than 2C
_PREMLP_REFUSED = [(192, 384), (128, 128)]


@pytest.mark.parametrize("c,hd", _PREMLP_REFUSED)
def test_fused_premlp_res_kernel_refuses_what_it_does_not_take(c, hd):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    x, ga, be, w1, b1, w2, b2 = _premlp_args(64, seed=0)
    with pytest.raises(ValueError):
        mod.fused_premlp_res(x.float(), ga, be, w1, b1, w2, b2)
    bf = torch.bfloat16
    z = lambda *s: torch.zeros(*s, device="cuda")
    args = (z(64, c).to(bf), z(c), z(c), z(c, hd).to(bf), z(hd),
            z(hd, c).to(bf), z(c))
    assert not mod.premlp_shape_ok(c, hd)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        mod.fused_premlp_res(*args)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        mod.fused_premlp_res_bwd(*args, args[0], 1)


# K5f's strip kernel at C = 128: row counts around the 16-row strip (one
# row, a strip less one, one, one and a row, eight strips less one), the
# 8 x 1251 rows of a batch of Transolver blocks, and the main path's 8 x
# 10,240
_PREMLP_STRIP_M = [1, 15, 16, 17, 127, 8 * 1251, 81920]


@pytest.mark.parametrize("m", _PREMLP_STRIP_M)
def test_fused_premlp_res_strip_kernel(m):
    """K5f at C = 128 (a warp a 16-row strip) against its plain version
    at the limit of the K5f test (2 bf16 ulps of the output scale), and the
    same bits twice."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    assert mod.premlp_plan(128, False)[0] == "rows"
    args = _premlp_args(m, seed=m + 7)
    before = mod.LAUNCHES_PREMLP
    out = mod.fused_premlp_res(*args)
    again = mod.fused_premlp_res(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_PREMLP == before + 2
    ref = mod.fused_premlp_res_reference(*args)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (m, 128)
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_ulps(ref))


@pytest.mark.parametrize("rows", ["constant", "large"])
def test_fused_premlp_res_strip_kernel_clamps_and_scales(rows):
    """K5f at C = 128 on the rows the strip kernel clamps or scales:
    constant rows (the fast variance E[x^2] - mu^2 is 0, clamped; xhat = 0,
    u = beta), among them an all-zero row, mixed with ordinary ones; and
    rows with |x| up to 1e3. Against the plain version at the limit of the
    K5f test (2 bf16 ulps of the output scale), the same bits twice."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    m = 8 * 16 + 5
    x, *rest = _premlp_args(m, seed=11)
    g = torch.Generator("cuda").manual_seed(12)
    if rows == "constant":
        vals = torch.randn(m, 1, device="cuda", generator=g)
        vals[0] = 0.0
        x = x.clone()
        x[::2] = vals[::2].expand(-1, 128).to(torch.bfloat16)
    else:
        x = (330.0 * torch.randn(m, 128, device="cuda", generator=g)
             ).clamp(-1e3, 1e3).to(torch.bfloat16)
        assert float(x.float().abs().max()) >= 900.0
    out = mod.fused_premlp_res(x, *rest)
    again = mod.fused_premlp_res(x, *rest)
    torch.cuda.synchronize()
    ref = mod.fused_premlp_res_reference(x, *rest)
    assert torch.equal(out, again) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_ulps(ref))


# (C, H, G): the default, then wider C, fewer heads, fewer and more slices,
# more heads; K6's row kernel takes the first three, the run-time path the
# rest (and K7's tiles their general variant for the next three); the last
# six are shapes the tiles refuse (a head width of 8 split in 4, more than
# 64 pooled sums a thread, heads and slices no powers of two, C above 512,
# and above 1024: a bf16 net at hidden 1152, 16 heads of 128 at 2048)
_POOL_SHAPES = [(128, 8, 32), (256, 8, 32), (512, 8, 32), (128, 4, 32),
                (128, 8, 16), (128, 8, 64), (128, 2, 64), (256, 16, 32),
                (384, 8, 32), (256, 4, 32), (128, 16, 32), (128, 16, 8),
                (512, 4, 128), (384, 6, 64), (1024, 8, 128), (1152, 8, 32),
                (2048, 16, 8)]
_POOL_RUNTIME_ONLY = _POOL_SHAPES[-6:]
_POOL_ID = lambda s: "C{}-H{}-G{}".format(*s)


def _pool_args(b, n, mask, seed, shared=False, shape=(128, 8, 32)):
    c, h, gs = shape
    d = c // h
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    bf = torch.bfloat16
    size = (n,) if shared else (b, n)
    if mask == "partial":
        m = (torch.rand(*size, device="cuda", generator=g) > 0.3).float()
    elif mask == "zero":
        m = torch.zeros(*size, device="cuda")
    else:
        m = torch.ones(*size, device="cuda")
    s = 0.1 * (128 / c) ** 0.5
    return (rnd(b, n, c).to(bf), m, (s * rnd(c, c)).to(bf),
            0.1 * rnd(c), (s * rnd(c, c)).to(bf),
            0.1 * rnd(c), (rnd(d, gs) / d ** 0.5).to(bf), 0.1 * rnd(gs),
            1 + torch.rand(h, device="cuda", generator=g))


def _check_pool(args, outs, refs, shape=(128, 8, 32)):
    """slice_w within `slice_w_tolerance` (a flipped logit rounding), and
    all but a few in 10^4 within 2^-7; tokens and norm within 1e-3 of
    their scale. Outside the default shape the tokens may also differ by
    one bf16 ulp of max|fx|: fx sums C products in another order, so at a
    rounding midpoint one element of fx flips (more often as C grows), and
    it moves each token it feeds by w·ulp(fx) <= ulp(max|fx|)."""
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    (w, tok, norm), (rw, rtok, rnorm) = outs, refs
    assert w.dtype == torch.bfloat16 and w.shape == rw.shape
    assert tok.shape == rtok.shape and norm.shape == rnorm.shape
    x, _, wfx, bfx, wx, bx, wsl, bsl, it = args
    l_max = float(mod.slice_logits(x, wx, bx, wsl, bsl).float().abs().max())
    tol = mod.slice_w_tolerance(l_max, float(it.max()))
    diff = (w.float() - rw.float()).abs()
    assert float(diff.max()) <= tol
    assert float((diff > 2 ** -7).float().mean()) < 1e-4
    flip, wflip = 0.0, 0.0
    if tuple(shape) != (128, 8, 32):
        fx = (x.float() @ wfx.float() + bfx).to(torch.bfloat16)
        flip = _ulps(fx, 1)
        if tuple(shape) in _POOL_RUNTIME_ONLY:
            # the run-time path sums xm (C products) and the logits (D
            # products) in another order than the plain version: at a few
            # rows of few-row lanes a flipped logit rounding moves one
            # node's weights of a head by up to `tol`, and with them the
            # norm by `tol` and the tokens by `tol` * max|fx|
            wflip = tol
            flip += tol * float(fx.float().abs().max())
    for a, r, extra in ((tok, rtok, flip), (norm, rnorm, wflip)):
        scale = max(float(r.abs().max()), 1e-6)
        torch.testing.assert_close(a, r, rtol=0, atol=1e-3 * scale + extra)


_POOL_SIZES = [(1, 1), (2, 63), (3, 256), (8, 1337), (2, 10240)]
_POOL_CASES = [(s, b, n, mask) for s in _POOL_SHAPES
               for b, n in (_POOL_SIZES if s == _POOL_SHAPES[0]
                            else [(1, 1), (2, 63), (3, 1337)])
               for mask in ("partial", "zero", "ones")]


@pytest.mark.parametrize("shape,b,n,mask", _POOL_CASES, ids=lambda v: (
    _POOL_ID(v) if isinstance(v, tuple) else str(v)))
def test_fused_slice_pool_kernel_matches_plain_version(shape, b, n, mask):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = _pool_args(b, n, mask, seed=b * n, shape=shape)
    before = mod.LAUNCHES
    outs = mod.fused_slice_pool_kernel(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    _check_pool(args, outs, mod.fused_slice_pool_reference(*args), shape)
    if mask == "zero":
        assert not outs[1].any() and not outs[2].any()


@pytest.mark.parametrize("shape", _POOL_SHAPES, ids=_POOL_ID)
def test_fused_slice_pool_kernel_shared_mask_and_repeatable_bits(shape):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = _pool_args(4, 3000, "partial", seed=7, shared=True, shape=shape)
    a = mod.fused_slice_pool_kernel(*args)
    b = mod.fused_slice_pool_kernel(*args)
    _check_pool(args, a, mod.fused_slice_pool_reference(*args), shape)
    for x, y in zip(a, b):
        assert torch.equal(x, y)            # no atomics: the same bits


# (C, H, G) the JAX package does not fuse, which the kernels refuse: C no
# multiple of 128, H·G no multiple of 128
_POOL_REFUSED = [(192, 8, 32), (128, 16, 6)]


@pytest.mark.parametrize("shape", _POOL_REFUSED, ids=_POOL_ID)
def test_fused_slice_pool_kernel_refuses_what_it_does_not_take(shape):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = list(_pool_args(2, 256, "ones", seed=0))
    with pytest.raises(ValueError):
        mod.fused_slice_pool_kernel(args[0].float(), *args[1:])
    assert not mod.slice_pool_shape_ok(*shape)
    bad = _pool_args(2, 64, "ones", seed=0, shape=shape)
    with pytest.raises(NotImplementedError, match="JAX package"):
        mod.fused_slice_pool_kernel(*bad)
    with pytest.raises(NotImplementedError, match="JAX package"):
        mod.fused_slice_pool_bwd_kernel(*bad, *_pool_cotangents(
            2, 64, seed=0, shape=shape))


def test_kernel_size_queries_agree_with_the_predicates():
    """The C size queries (gfvgn_premlp_workspace,
    gfvgn_slice_pool_workspace) take exactly the shapes the Python
    predicates take, over a grid of widths, heads and slices."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    from gen_fvgn_tpu_torch.ops._cuda_build import load_library
    lib = load_library()
    for c in range(64, 4097, 64):
        for bwd in (0, 1):
            took = lib.gfvgn_premlp_workspace(c, 64, 1, bwd) >= 0
            assert took == (fm.premlp_plan(c, bool(bwd)) is not None), c
        for h in (1, 2, 3, 4, 6, 8, 16, 32, 64):
            for g in (1, 8, 16, 24, 32, 64, 128, 256):
                for bwd in (0, 1):
                    took = lib.gfvgn_slice_pool_workspace(c, h, g, 2, 300,
                                                          bwd) >= 0
                    ok = fsa.slice_pool_plan(c, h, g, bool(bwd)) is not None
                    assert took == ok, (c, h, g, bwd)


# ---------------------------------------------------------------------------
# The backward kernels K3, K4b, K5b, K7 against their plain versions.
# Tolerance: 2 bf16 ulps of each output's scale — dx, dpre and the bf16
# weight gradients, and also the float32 bias/γ/β/temperature gradients,
# which sum terms downstream of bf16 roundings (dy, dh2pre, dh1pre, the
# projections) that a float32 sum in another order can move by a step.
# ---------------------------------------------------------------------------


def _close(got, ref, name):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape, name
    scale = float(ref.abs().max())
    if scale == 0.0:
        assert not got.any(), name
        return
    torch.testing.assert_close(got, ref, rtol=0, atol=_ulps(ref),
                               msg=lambda m: f"{name}: {m}")


def _grads_equal(a, b):
    flat = lambda gs: [t for t in gs if isinstance(t, torch.Tensor)] + [
        t for tup in gs if isinstance(tup, tuple) for t in tup]
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


# (5, 5): lanes of one row each; (8 * 65, 8): each lane ends in a ragged
# 1-row tile and the weight-gradient pass's chunks end inside a lane
@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("m,lanes", [(1, 1), (5, 5), (63, 1), (1000, 1),
                                     (1280, 2), (8 * 65, 8), (8 * 1337, 8)])
@pytest.mark.parametrize("units,has_pre,res_idx,res_dual", _FORMS)
def test_fused_mlp_ln_bwd_kernel_matches_plain_version(m, lanes, units,
                                                       has_pre, res_idx,
                                                       res_dual, h):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    widths = _widths(units, h)
    parts, w1s, b1, w2, b2, w3, b3, gamma, _, pres = _mlp_args(
        m, widths, has_pre, h, seed=m + len(widths), h=h)
    g = torch.Generator("cuda").manual_seed(m)
    douts = [torch.randn(m, h, device="cuda", generator=g).to(torch.bfloat16)
             for _ in range(2 if res_dual else 1)]
    args = (parts, w1s, b1, w2, b2, w3, b3, gamma, pres, douts, res_idx,
            res_dual, lanes)
    before = mod.LAUNCHES_LN_BWD
    got = mod.fused_mlp_ln_bwd(*args)
    again = mod.fused_mlp_ln_bwd(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_LN_BWD == before + 2
    assert _grads_equal(got, again)             # no atomics: the same bits
    ref = mod.fused_mlp_ln_bwd_reference(*args)
    for name in got._fields:
        a, r = getattr(got, name), getattr(ref, name)
        if isinstance(a, tuple):
            assert len(a) == len(r), name
            for i, (x, y) in enumerate(zip(a, r)):
                assert x.dtype == y.dtype, name
                _close(x, y, f"{name}[{i}]")
        else:
            assert a.dtype == r.dtype, name
            _close(a, r, name)


def test_fused_mlp_ln_bwd_kernel_zero_cotangent_gives_zero():
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    parts, w1s, b1, w2, b2, w3, b3, gamma, _, pres = _mlp_args(
        300, [128], True, 128, seed=3)
    zero = torch.zeros(300, 128, device="cuda", dtype=torch.bfloat16)
    got = mod.fused_mlp_ln_bwd(parts, w1s, b1, w2, b2, w3, b3, gamma, pres,
                               [zero, zero], 0, True, 1)
    for t in (*got.dxs, *got.dpres, *got.dw1s, got.db1, got.dw2, got.db2,
              got.dw3, got.db3, got.dgamma, got.dbeta):
        assert not t.any()


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("m,lanes", [(1, 1), (5, 5), (65, 1), (2 * 640, 2),
                                     (8 * 1337, 8)])
@pytest.mark.parametrize("d_out", [3, 16])
def test_fused_mlp_noln_bwd_kernel_matches_plain_version(m, lanes, d_out, h):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    parts, w1s, b1, w2, b2, w3, b3, _, _, _ = _mlp_args(
        m, [h], False, d_out, seed=m + d_out, h=h)
    g = torch.Generator("cuda").manual_seed(m)
    dout = torch.randn(m, d_out, device="cuda", generator=g).to(torch.bfloat16)
    args = (parts[0], w1s[0], b1, w2, b2, w3, b3, dout, lanes)
    before = mod.LAUNCHES_NOLN_BWD
    got, again = mod.fused_mlp_noln_bwd(*args), mod.fused_mlp_noln_bwd(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_NOLN_BWD == before + 2
    assert _grads_equal(got, again)
    ref = mod.fused_mlp_noln_bwd_reference(*args)
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"),
                          got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        _close(a, r, name)


# lanes of one row (5, 5) and ragged lanes (8 * 65, 8: each lane ends in a
# ragged tile) at every width
_PREMLP_BWD = [(128, m, lanes) for m, lanes in (
    (1, 1), (63, 1), (65, 1), (1000, 1), (8 * 1251, 8))] + [
    (c, m, lanes) for c in _PREMLP_C for m, lanes in ((5, 5), (8 * 65, 8))] \
    + [(c, 1000, 2) for c in _PREMLP_C[1:]]


@pytest.mark.parametrize("c,m,lanes", _PREMLP_BWD)
def test_fused_premlp_res_bwd_kernel_matches_plain_version(c, m, lanes):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    args = _premlp_args(m, seed=m + c - 128, c=c)
    g = torch.Generator("cuda").manual_seed(m + 1)
    dout = torch.randn(m, c, device="cuda", generator=g).to(torch.bfloat16)
    before = mod.LAUNCHES_PREMLP_BWD
    got = mod.fused_premlp_res_bwd(*args, dout, lanes)
    again = mod.fused_premlp_res_bwd(*args, dout, lanes)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_PREMLP_BWD == before + 2
    assert _grads_equal(got, again)
    ref = mod.fused_premlp_res_bwd_reference(*args, dout, lanes)
    for name, a, r in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                           "db2"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        _close(a, r, name)


def _pool_cotangents(b, n, seed, shape=(128, 8, 32)):
    c, h, gs = shape
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    return (rnd(b, n, h * gs).to(torch.bfloat16), rnd(b, h, gs, c // h),
            rnd(b, h, gs))


# every shape; the default with the forward's sizes, the others with a
# ragged tile, batch lanes of one row (1, 1) and ragged lanes (3, 1337)
@pytest.mark.parametrize("shape,b,n,mask", _POOL_CASES, ids=lambda v: (
    _POOL_ID(v) if isinstance(v, tuple) else str(v)))
def test_fused_slice_pool_bwd_kernel_matches_plain_version(shape, b, n, mask):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = _pool_args(b, n, mask, seed=b * n + 1, shape=shape)
    cots = _pool_cotangents(b, n, seed=b + n, shape=shape)
    before = mod.LAUNCHES_BWD
    got = mod.fused_slice_pool_bwd_kernel(*args, *cots)
    again = mod.fused_slice_pool_bwd_kernel(*args, *cots)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_BWD == before + 2
    assert _grads_equal(got, again)
    ref = mod.fused_slice_pool_bwd_reference(*args, *cots)
    for name in got._fields:
        a, r = getattr(got, name), getattr(ref, name)
        assert a.dtype == r.dtype and a.shape == r.shape, name
        _close(a, r, name)


def test_fused_slice_pool_bwd_kernel_shared_mask_and_refusals():
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = _pool_args(4, 3000, "partial", seed=9, shared=True)
    cots = _pool_cotangents(4, 3000, seed=9)
    got = mod.fused_slice_pool_bwd_kernel(*args, *cots)
    ref = mod.fused_slice_pool_bwd_reference(*args, *cots)
    for name in got._fields:
        _close(getattr(got, name), getattr(ref, name), name)
    with pytest.raises(ValueError):
        mod.fused_slice_pool_bwd_kernel(*args, cots[0].float(), *cots[1:])
    with pytest.raises(NotImplementedError):          # (C, H, G) (128, 16, 6)
        mod.fused_slice_pool_bwd_kernel(
            *args[:6], torch.zeros(8, 6, device="cuda", dtype=torch.bfloat16),
            torch.zeros(6, device="cuda"), torch.ones(16, device="cuda"),
            cots[0][..., :96].contiguous(), torch.zeros(4, 16, 6, 8,
                                                        device="cuda"),
            torch.zeros(4, 16, 6, device="cuda"))
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    x, ga, be, w1, b1, w2, b2 = _premlp_args(64, seed=0)
    with pytest.raises(ValueError):
        fm.fused_premlp_res_bwd(x, ga, be, w1, b1, w2, b2, x.float(), 1)
    with pytest.raises(ValueError):
        fm.fused_premlp_res_bwd(x, ga, be, w1, b1, w2, b2, x, 3)   # 64 % 3


def test_mixed_step_kernels_match_plain_versions():
    """One `MixedTrainStepBlock` step of two groups (a quad and a triangle
    cavity, one group padded with a weight-0 row) at the Config's widths
    (TransFVGN_v2, hidden 128, bf16): the summed gradients with the kernels
    against those with their plain versions, held to chip_smoke.py's limits
    for step 1 (relative norm 2e-2, per tensor 3e-2, cosine 0.999, loss
    1e-4), and every group launching a train step's kernels."""
    _need_card()
    import contextlib

    from gen_fvgn_tpu_torch import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     cavity_tri_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.ops import fused_mlp, plain_versions, spmm
    from gen_fvgn_tpu_torch.training.normalizer import init_normalizer
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train_block import (
        MixedTrainStepBlock, init_train_state_block)
    cfg = Config(batch_size=4, dataset_size=8, mixed_case_batches=True,
                 engine="block")
    kw = dict(continuity=1, convection=1, grad_p=1, mu=0.05, sigma=(1, 1, 1))
    pool = EnvPool([], cfg, seed=0, cases=[
        synthetic_case(cavity_quad_mesh(16), **kw),
        synthetic_case(cavity_tri_mesh(12), **kw)])
    batch = [(0, np.asarray([0, 2, 4, 0], np.int32),
              np.asarray([0.25, 0.25, 0.25, 0.0], np.float32), 3),
             (1, np.asarray([1], np.int32), np.full(1, 0.25, np.float32), 1)]
    _, sim = init_train_state_block(cfg, seed=0)
    params = list(sim.parameters())

    def run(plain):
        mixed = MixedTrainStepBlock(cfg, sim)
        weights = [torch.from_numpy(w).cuda() for _, _, w, _ in batch]
        with plain_versions() if plain else contextlib.nullcontext():
            sums = mixed.init_sums()
            for (ci, idxs, _, _), w in zip(batch, weights):
                sums = mixed.group_stats(sums, pool.gather_block(idxs),
                                         pool.statics[ci], w)
            norm = mixed.norm_update(init_normalizer(9), sums)
            acc = mixed.init_acc()
            for (ci, idxs, _, _), w in zip(batch, weights):
                acc, _ = mixed.group_grads(norm, acc, pool.gather_block(idxs),
                                           pool.statics[ci], w)
        torch.cuda.synchronize()
        return float(acc["loss"]), acc["gsum"]

    before = (spmm.LAUNCHES, fused_mlp.LAUNCHES_LN, fused_mlp.LAUNCHES_LN_BWD)
    loss_k, g_k = run(False)
    after = (spmm.LAUNCHES, fused_mlp.LAUNCHES_LN, fused_mlp.LAUNCHES_LN_BWD)
    assert [a - b for a, b in zip(after, before)] == [2 * 48, 2 * 14, 2 * 14]
    loss_p, g_p = run(True)
    assert (spmm.LAUNCHES, fused_mlp.LAUNCHES_LN,
            fused_mlp.LAUNCHES_LN_BWD) == after
    flat = lambda g: torch.cat([x.reshape(-1).double() for x in g])
    k, p = flat(g_k), flat(g_p)
    assert float((k - p).norm() / p.norm()) <= 2e-2
    for a, b in zip(g_k, g_p):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        if bool(b.any()):
            assert float((a - b).norm() / b.norm()) <= 3e-2
            assert float(a @ b / (a.norm() * b.norm())) >= 1 - 1e-3
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    assert len(g_k) == len(params)


# the segment engine's forms of K2/K3: the edge MLP's one plain part 3h
# wide, the node MLP's one part 1.5h wide (at h = 128 zero-padded to 256 by
# `fused_mlp_ln_parts`), neither with a pre-projected input or a residual;
# row counts that are odd multiples of 128 (the segment pool pads to 128)
_SEGMENT_M = [(1, 1), (3 * 128, 1), (8 * 81 * 128, 8), (8 * 79 * 128, 8)]


@pytest.mark.parametrize("units", [[3], [2]], ids=["edge-3h", "node-2h"])
@pytest.mark.parametrize("m,lanes", _SEGMENT_M)
@pytest.mark.parametrize("h", [128, 256])
def test_fused_mlp_segment_forms_match_plain_versions(units, m, lanes, h):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    widths = _widths(units, h)
    parts, w1s, b1, w2, b2, w3, b3, gamma, beta, _ = _mlp_args(
        m, widths, False, h, seed=m + h, h=h)
    fwd = (parts, w1s, b1, w2, b2, w3, b3, gamma, beta, ())
    before = (mod.LAUNCHES_LN, mod.LAUNCHES_LN_BWD)
    out = mod.fused_mlp_ln(*fwd)
    g = torch.Generator("cuda").manual_seed(m)
    dout = torch.randn(m, h, device="cuda", generator=g).to(torch.bfloat16)
    bwd = (parts, w1s, b1, w2, b2, w3, b3, gamma, (), [dout], None, False,
           lanes)
    got = mod.fused_mlp_ln_bwd(*bwd)
    again = mod.fused_mlp_ln_bwd(*bwd)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES_LN, mod.LAUNCHES_LN_BWD) == (before[0] + 1,
                                                      before[1] + 2)
    ref = mod.fused_mlp_ln_reference(*fwd)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (m, h)
    _close(out, ref, "out")
    assert _grads_equal(got, again)
    want = mod.fused_mlp_ln_bwd_reference(*bwd)
    for name in got._fields:
        a, r = getattr(got, name), getattr(want, name)
        for i, (x, y) in enumerate(zip(*((a, r) if isinstance(a, tuple)
                                          else ((a,), (r,))))):
            assert x.dtype == y.dtype, name
            _close(x, y, f"{name}[{i}]")


def test_node_mlp_192_wide_part_through_the_wrapper():
    """The segment node MLP's 192-wide part through `fused_mlp_ln_parts`
    with autograd on the card: K2 and K3 launch on the part padded to 256,
    dx and dW1 come back 192 wide, all against the plain versions."""
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    from gen_fvgn_tpu_torch.ops import plain_versions
    m, h = 8 * 81 * 128, 128
    parts, w1s, b1, w2, b2, w3, b3, gamma, beta, _ = _mlp_args(
        m, [192], False, h, seed=3, h=h)
    x = parts[0].float().requires_grad_()
    w1 = w1s[0].float().requires_grad_()
    g = torch.randn(m, h, device="cuda").to(torch.bfloat16)

    def run():
        out = mod.fused_mlp_ln_parts([x], w1, b1, w2, b2, w3, b3, gamma,
                                     beta, lanes=8)
        dx, dw1 = torch.autograd.grad(out, [x, w1], g)
        return out, dx, dw1
    before = (mod.LAUNCHES_LN, mod.LAUNCHES_LN_BWD)
    got = run()
    torch.cuda.synchronize()
    assert (mod.LAUNCHES_LN, mod.LAUNCHES_LN_BWD) == (before[0] + 1,
                                                      before[1] + 1)
    with plain_versions():
        want = run()
    assert tuple(got[1].shape) == (m, 192) and tuple(got[2].shape) == (192, h)
    for name, a, r in zip(("out", "dx", "dW1"), got, want):
        _close(a, r, name)


def test_segment_train_step_kernels_match_plain_versions():
    """One segment train step's gradients at the Config's widths
    (TransFVGN_v2, hidden 128, bf16, 3 blocks a processor) on a 16 x 16
    cavity padded to 384 nodes and 640 faces (odd multiples of 128, so the
    slice attention takes its plain form there, as in JAX: N % 256 != 0),
    with the kernels against the plain versions, held to chip_smoke.py's
    step-1 limits; the launches of one step: 14 + 14 fused_mlp_ln, 1 + 1
    fused_mlp_noln, 2 + 2 fused_premlp_res, no slice pool and no spmm."""
    _need_card()
    import contextlib

    from gen_fvgn_tpu_torch import Config
    from gen_fvgn_tpu_torch.meshes.synthetic import (cavity_quad_mesh,
                                                     synthetic_case)
    from gen_fvgn_tpu_torch.ops import (fused_mlp, fused_slice_attn,
                                        plain_versions, spmm)
    from gen_fvgn_tpu_torch.training.forward import (forward_batch,
                                                     training_loss)
    from gen_fvgn_tpu_torch.training.pool import EnvPool
    from gen_fvgn_tpu_torch.training.train import init_train_state
    cfg = Config(batch_size=4, dataset_size=4)
    assert cfg.engine == "segment"
    pool = EnvPool([], cfg, seed=0, engine="segment", cases=[synthetic_case(
        cavity_quad_mesh(16), continuity=1, convection=1, grad_p=1, mu=0.05,
        sigma=(1, 1, 1))])
    assert (pool.sizes.n_nodes, pool.sizes.n_faces) == (384, 640)
    batch = pool.gather_batch(np.arange(4))
    state, sim = init_train_state(cfg, seed=0)
    params = list(sim.parameters())

    def grads(plain):
        with plain_versions() if plain else contextlib.nullcontext():
            loss = training_loss(forward_batch(sim, state.norm_state, batch,
                                               cfg), cfg)
            g = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return float(loss), g

    count = lambda: (spmm.LAUNCHES, fused_mlp.LAUNCHES_LN,
                     fused_mlp.LAUNCHES_LN_BWD, fused_mlp.LAUNCHES_NOLN,
                     fused_mlp.LAUNCHES_NOLN_BWD, fused_mlp.LAUNCHES_PREMLP,
                     fused_mlp.LAUNCHES_PREMLP_BWD, fused_slice_attn.LAUNCHES)
    before = count()
    loss_k, g_k = grads(False)
    after = count()
    assert [a - b for a, b in zip(after, before)] == [0, 14, 14, 1, 1, 2, 2,
                                                      0]
    loss_p, g_p = grads(True)
    assert count() == after
    flat = lambda g: torch.cat([x.reshape(-1).double() for x in g])
    k, p = flat(g_k), flat(g_p)
    assert float((k - p).norm() / p.norm()) <= 2e-2
    for a, b in zip(g_k, g_p):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        if bool(b.any()):
            assert float((a - b).norm() / b.norm()) <= 3e-2
            assert float(a @ b / (a.norm() * b.norm())) >= 1 - 1e-3
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
