"""PyTorch port, the CUDA kernels themselves against their plain PyTorch
versions, on the card. A CUDA kernel has no interpret mode, so these tests
need an NVIDIA card and nvcc and skip elsewhere (they decide that inside the
test, never while the module is imported). Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q

`chip_smoke.py` makes the same comparisons at the main path's full shapes;
these cover the edges: ragged row counts, every operand/output type of the
sparse apply, unbatched operands, all-zero and partial node masks, shared
and per-lane masks, and the bitwise repeatability of the slice pool."""

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


def _mlp_args(m, widths, has_pre, d_out, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    bf = torch.bfloat16
    parts = [rnd(m, k).to(bf) for k in widths]
    w1s = [(rnd(k, 128) / max(sum(widths), 1) ** 0.5).to(bf) for k in widths]
    pres = (rnd(m, 128).to(bf),) if has_pre else ()
    return (parts, w1s, 0.1 * rnd(128), (rnd(128, 128) / 128 ** 0.5).to(bf),
            0.1 * rnd(128), (rnd(128, d_out) / 128 ** 0.5).to(bf),
            0.1 * rnd(d_out), 1 + 0.1 * rnd(d_out), 0.1 * rnd(d_out), pres)


@pytest.mark.parametrize("m", [1, 63, 64, 1000, 8 * 1337])
@pytest.mark.parametrize("widths,has_pre,res_idx,res_dual", [
    ([], True, None, False),
    ([128], True, 0, True),
    ([64, 128], False, 1, False),
    ([128, 128], True, None, False)])
def test_fused_mlp_ln_kernel_matches_plain_version(m, widths, has_pre,
                                                   res_idx, res_dual):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    args = _mlp_args(m, widths, has_pre, 128, seed=m)
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


@pytest.mark.parametrize("m", [1, 65, 8 * 1337])
@pytest.mark.parametrize("d_out", [3, 16])
def test_fused_mlp_noln_kernel_matches_plain_version(m, d_out):
    _need_card()
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    parts, w1s, b1, w2, b2, w3, b3, _, _, _ = _mlp_args(
        m, [128], False, d_out, seed=m + d_out)
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
