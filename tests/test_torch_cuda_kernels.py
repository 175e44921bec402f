"""PyTorch port, the CUDA kernels themselves against their plain PyTorch
versions, on the card. A CUDA kernel has no interpret mode, so these tests
need an NVIDIA card and nvcc and skip elsewhere (they decide that inside the
test, never while the module is imported). Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q

`chip_smoke.py` makes the same comparisons at the main path's full shapes;
these cover the edges: ragged row counts, every operand/output type of the
sparse apply and of the paired applies (K8, K9: B = 1, empty rows, float32
operands, H = 64 and 128), unbatched operands, all-zero and partial node
masks, shared and per-lane masks, the fused MLP kernels (K2, K3, K4f, K4b)
at hidden widths 128 and 256 (and 384 for the 32-row tiles) in every form
the nets use, with lanes of one row and ragged last tiles, and the bitwise
repeatability of the backward kernels and the slice pool."""

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


def _premlp_args(m, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    bf = torch.bfloat16
    return ((2 * rnd(m, 128) + 0.5).to(bf), 1 + 0.1 * rnd(128),
            0.1 * rnd(128), (rnd(128, 256) / 128 ** 0.5).to(bf),
            0.1 * rnd(256), (rnd(256, 128) / 256 ** 0.5).to(bf),
            0.1 * rnd(128))


@pytest.mark.parametrize("m", [1, 63, 64, 65, 1000, 8 * 1251])
def test_fused_premlp_res_kernel_matches_plain_version(m):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    args = _premlp_args(m, seed=m)
    before = mod.LAUNCHES_PREMLP
    out = mod.fused_premlp_res(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_PREMLP == before + 1
    ref = mod.fused_premlp_res_reference(*args)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (m, 128)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_ulps(ref))


def test_fused_premlp_res_kernel_refuses_what_it_does_not_take():
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    x, ga, be, w1, b1, w2, b2 = _premlp_args(64, seed=0)
    with pytest.raises(ValueError):
        mod.fused_premlp_res(x.float(), ga, be, w1, b1, w2, b2)
    with pytest.raises(NotImplementedError):
        mod.fused_premlp_res(x, ga, be, w1[:, :128], b1[:128],
                             w2[:128], b2)


def _pool_args(b, n, mask, seed, shared=False):
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    bf = torch.bfloat16
    shape = (n,) if shared else (b, n)
    if mask == "partial":
        m = (torch.rand(*shape, device="cuda", generator=g) > 0.3).float()
    elif mask == "zero":
        m = torch.zeros(*shape, device="cuda")
    else:
        m = torch.ones(*shape, device="cuda")
    return (rnd(b, n, 128).to(bf), m, (0.1 * rnd(128, 128)).to(bf),
            0.1 * rnd(128), (0.1 * rnd(128, 128)).to(bf), 0.1 * rnd(128),
            (rnd(16, 32) / 4).to(bf), 0.1 * rnd(32),
            1 + torch.rand(8, device="cuda", generator=g))


def _check_pool(args, outs, refs):
    """slice_w within `slice_w_tolerance` (a flipped logit rounding), and
    all but a few in 10^4 within 2^-7; tokens and norm within 1e-3 of
    their scale."""
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    (w, tok, norm), (rw, rtok, rnorm) = outs, refs
    assert w.dtype == torch.bfloat16 and w.shape == rw.shape
    assert tok.shape == rtok.shape and norm.shape == rnorm.shape
    x, _, _, _, wx, bx, wsl, bsl, it = args
    l_max = float(mod.slice_logits(x, wx, bx, wsl, bsl).float().abs().max())
    tol = mod.slice_w_tolerance(l_max, float(it.max()))
    diff = (w.float() - rw.float()).abs()
    assert float(diff.max()) <= tol
    assert float((diff > 2 ** -7).float().mean()) < 1e-4
    for a, r in ((tok, rtok), (norm, rnorm)):
        scale = max(float(r.abs().max()), 1e-6)
        torch.testing.assert_close(a, r, rtol=0, atol=1e-3 * scale)


@pytest.mark.parametrize("b,n", [(1, 1), (2, 63), (3, 256), (8, 1337),
                                 (2, 10240)])
@pytest.mark.parametrize("mask", ["partial", "zero", "ones"])
def test_fused_slice_pool_kernel_matches_plain_version(b, n, mask):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = _pool_args(b, n, mask, seed=b * n)
    before = mod.LAUNCHES
    outs = mod.fused_slice_pool_kernel(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    _check_pool(args, outs, mod.fused_slice_pool_reference(*args))
    if mask == "zero":
        assert not outs[1].any() and not outs[2].any()


def test_fused_slice_pool_kernel_shared_mask_and_repeatable_bits():
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = _pool_args(4, 3000, "partial", seed=7, shared=True)
    a = mod.fused_slice_pool_kernel(*args)
    b = mod.fused_slice_pool_kernel(*args)
    _check_pool(args, a, mod.fused_slice_pool_reference(*args))
    for x, y in zip(a, b):
        assert torch.equal(x, y)            # no atomics: the same bits


def test_fused_slice_pool_kernel_refuses_what_it_does_not_take():
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = list(_pool_args(2, 256, "ones", seed=0))
    with pytest.raises(ValueError):
        mod.fused_slice_pool_kernel(args[0].float(), *args[1:])
    bad = list(args)
    bad[6] = torch.zeros(32, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        mod.fused_slice_pool_kernel(*bad)


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


@pytest.mark.parametrize("m,lanes", [(1, 1), (63, 1), (65, 1), (1000, 1),
                                     (8 * 1251, 8)])
def test_fused_premlp_res_bwd_kernel_matches_plain_version(m, lanes):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    args = _premlp_args(m, seed=m)
    g = torch.Generator("cuda").manual_seed(m + 1)
    dout = torch.randn(m, 128, device="cuda", generator=g).to(torch.bfloat16)
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


def _pool_cotangents(b, n, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    return (rnd(b, n, 256).to(torch.bfloat16), rnd(b, 8, 32, 16),
            rnd(b, 8, 32))


@pytest.mark.parametrize("b,n", [(1, 1), (2, 63), (3, 256), (8, 1337),
                                 (2, 10240)])
@pytest.mark.parametrize("mask", ["partial", "zero", "ones"])
def test_fused_slice_pool_bwd_kernel_matches_plain_version(b, n, mask):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as mod
    args = _pool_args(b, n, mask, seed=b * n + 1)
    cots = _pool_cotangents(b, n, seed=b + n)
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
    with pytest.raises(NotImplementedError):
        mod.fused_slice_pool_bwd_kernel(
            *args[:6], torch.zeros(32, 32, device="cuda",
                                   dtype=torch.bfloat16), *args[7:], *cots)
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    x, ga, be, w1, b1, w2, b2 = _premlp_args(64, seed=0)
    with pytest.raises(ValueError):
        fm.fused_premlp_res_bwd(x, ga, be, w1, b1, w2, b2, x.float(), 1)
    with pytest.raises(ValueError):
        fm.fused_premlp_res_bwd(x, ga, be, w1, b1, w2, b2, x, 3)   # 64 % 3
