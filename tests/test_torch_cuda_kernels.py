"""PyTorch port, the CUDA kernels themselves against their plain PyTorch
versions, on the card. A CUDA kernel has no interpret mode, so these tests
need an NVIDIA card and nvcc and skip elsewhere (they decide that inside the
test, never while the module is imported). Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q

`chip_smoke.py` makes the same comparisons at the main path's full shapes;
these cover the edges: ragged row counts, every operand/output type of the
sparse apply, unbatched operands."""

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
