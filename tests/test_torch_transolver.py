"""PyTorch port, the Transolver modules and their kernels' plain versions
against the JAX package on the same NumPy inputs and weights.

K5f `fused_premlp_res_reference` vs the JAX `fused_premlp_res_parts` and K6
`fused_slice_pool_reference` vs the JAX `fused_slice_pool`, both of which run
their Pallas kernels in interpret mode on the CPU (as tests/test_fused_mlp.py
and tests/test_fused_slice_attn.py run them). Then `PhysicsAttention` and
`TransolverBlock` in both forms against flax: the fused form at C = 128,
H = 8, G = 32, N = 256 and 512 in bf16, the plain-layer form at hidden 32 in
float32 and bf16.

Tolerances, each with its reason:
- K5f: 2 bf16 ulps of the output scale, and nearly all entries bit-equal
  (both sides round u, h and the output at the same points; their float32
  sums run in another order, which can move one rounding by one step).
- K6: slice_w within 2⁻⁷ (weights ≤ 1; a flipped bf16 rounding of slice_w
  or of a small logit), tokens and norm within 1e-3 of their scale (float32
  sums in another order; one flipped rounding of fx moves one row).
  Measured on these inputs: slice_w 1.2e-4, tokens 6e-6 and norm 3e-7 of
  their scale.
- bf16 modules: 4 bf16 ulps of the output scale (a few roundings of the
  stream on each side), median far below.
- float32 modules: 2e-6 of the output scale (measured 5.0e-7 for the
  attention, 2.4e-7 for the block, over seeds 30-32; the block's plain
  LayerNorm rounds in flax's order, (x − μ)·(rstd·γ) + β).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import jax_kernels_on, numpy_tree

torch.set_num_threads(1)

C, H, G = 128, 8, 32
D = C // H


def _ulps(ref, n):
    scale = float(np.abs(ref).max())
    return n * 2.0 ** (np.floor(np.log2(scale)) - 7)


# ---------------------------------------------------------------- K5f


def _premlp_operands(seed, m=300, c=C):
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(x=g(m, c) * 2.0 + 0.5, scale=1.0 + 0.1 * g(c),
                bias=0.1 * g(c), w1=g(c, 2 * c) / np.sqrt(c),
                b1=0.1 * g(2 * c), w2=g(2 * c, c) / np.sqrt(2 * c),
                b2=0.1 * g(c))


ORDER = ("x", "scale", "bias", "w1", "b1", "w2", "b2")


def test_premlp_reference_matches_jax():
    """M = 300 rows: not a multiple of the JAX row tile (the JAX wrapper
    pads, the port's kernel masks its ragged tile)."""
    _premlp_vs_jax(C, seed=0)


def test_premlp_reference_matches_jax_at_c256():
    """The same at C = 256 (hidden 512), a width the kernels now take."""
    _premlp_vs_jax(256, seed=2)


@pytest.mark.parametrize("c", [768, 1024])
def test_premlp_reference_matches_jax_at_wide_c(c):
    """The same at C = 768 and 1024 (hidden 2C), the widest the kernels
    take."""
    _premlp_vs_jax(c, seed=c)


def _premlp_vs_jax(c, seed):
    from gen_fvgn_tpu.ops.fused_mlp import fused_premlp_res_parts as jfn
    from gen_fvgn_tpu_torch.ops.fused_mlp import fused_premlp_res_parts as tfn
    ops = _premlp_operands(seed, c=c)
    ref = np.asarray(jfn(*[jnp.asarray(ops[k]) for k in ORDER],
                         dtype=jnp.bfloat16), np.float32)
    got = tfn(*[torch.from_numpy(ops[k]) for k in ORDER],
              dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_ulps(ref, 2))
    assert (got == ref).mean() > 0.98


def test_premlp_residual_joins_before_the_rounding():
    """out = bf16(MLP(x) + x) with the sum in float32: not the K2 epilogue's
    bf16(MLP(x)) + x in bf16."""
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    ops = {k: torch.from_numpy(v) for k, v in _premlp_operands(1).items()}
    bf = torch.bfloat16
    x = ops["x"].to(bf)
    args = (ops["scale"], ops["bias"], ops["w1"].to(bf), ops["b1"],
            ops["w2"].to(bf), ops["b2"])
    out = fm.fused_premlp_res_reference(x, *args)
    mlp32 = _premlp_branch_f32(x, *args)
    assert torch.equal(out, (mlp32 + x.float()).to(bf))
    assert not torch.equal(out, mlp32.to(bf) + x)


def _premlp_branch_f32(x, gamma, beta, w1, b1, w2, b2):
    """W2·gelu(W1·bf16(LN(x)·γ+β) + b1) + b2 in float32, before the
    residual and the rounding (the plain version's arithmetic)."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import (LN_EPS, _dot_f32,
                                                  _gelu_tanh)
    f32 = torch.float32
    x32 = x.to(f32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    u16 = ((x32 - mu) * torch.rsqrt(var + LN_EPS) * gamma + beta).to(x.dtype)
    h = _gelu_tanh(_dot_f32(u16, w1) + b1)
    return _dot_f32(h.to(x.dtype), w2) + b2


# ---------------------------------------------------------------- K6


def _slice_operands(seed, n=256, batch=2, mask="partial", spread=1.0,
                    shape=(C, H, G)):
    c, h, gs = shape
    d = c // h
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(size=s).astype(np.float32)
    x = g(batch, n, c)
    if mask == "partial":
        m = (rng.random((batch, n)) > 0.2).astype(np.float32)
    elif mask == "zero":
        m = np.zeros((batch, n), np.float32)
    else:
        m = np.ones((batch, n), np.float32)
    s = np.sqrt(C / c)          # the default's scales at C = 128
    return dict(x=x, mask=m, wfx=0.4 * s * g(c, c) / 4, bfx=0.1 * g(c),
                wx=0.4 * s * g(c, c) / 4 * spread, bx=0.1 * g(c),
                wsl=g(d, gs) * spread * np.sqrt(D / d), bsl=0.1 * g(gs),
                it=(1.0 + rng.random(h)).astype(np.float32))


def _shape_of(ops):
    d, g = ops["wsl"].shape
    c = ops["x"].shape[-1]
    return c, c // d, g, d


def _jax_slice_pool(ops):
    """The JAX fused_slice_pool per graph (block-diagonal slice kernel,
    per-lane bias and inverse-temperature rows); tok_full's per-head
    diagonal blocks as [B, H, G, D]."""
    from gen_fvgn_tpu.ops.fused_slice_attn import fused_slice_pool
    c, h, g, d = _shape_of(ops)
    wsl_bd = jnp.kron(jnp.eye(h), jnp.asarray(ops["wsl"]))
    outs = [fused_slice_pool(
        jnp.asarray(ops["x"][i], jnp.bfloat16), jnp.asarray(ops["mask"][i]),
        jnp.asarray(ops["wfx"]), jnp.asarray(ops["bfx"]),
        jnp.asarray(ops["wx"]), jnp.asarray(ops["bx"]), wsl_bd,
        jnp.tile(jnp.asarray(ops["bsl"]), h),
        jnp.repeat(jnp.asarray(ops["it"]), g), heads=h, slice_num=g)
        for i in range(ops["x"].shape[0])]
    w = np.stack([np.asarray(o[0], np.float32) for o in outs])
    t4 = [np.asarray(o[1], np.float32).reshape(h, g, h, d) for o in outs]
    tok = np.stack([t[np.arange(h), :, np.arange(h), :] for t in t4])
    norm = np.stack([np.asarray(o[2], np.float32).reshape(h, g)
                     for o in outs])
    return w, tok, norm


def _torch_slice_pool(ops, mask=None):
    from gen_fvgn_tpu_torch.ops.fused_slice_attn import fused_slice_pool
    _, h, g, _ = _shape_of(ops)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    w, tok, norm = fused_slice_pool(
        t["x"].to(torch.bfloat16), t["mask"] if mask is None else mask,
        t["wfx"], t["bfx"], t["wx"], t["bx"], t["wsl"], t["bsl"], t["it"],
        heads=h, slice_num=g)
    assert w.dtype == torch.bfloat16 and tok.dtype == norm.dtype == \
        torch.float32
    return w.float().numpy(), tok.numpy(), norm.numpy()


def _close_scaled(got, ref, rel):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


# (C, H, G) beyond the default that the kernels take: wider C, fewer heads,
# fewer and more slices; then 16 heads of 8 with 8 slices, 4 heads of 128
# with 128 slices, and 6 heads of 64 with 64 slices (the run-time path)
_OTHER_SHAPES = [(256, 8, 32), (128, 4, 32), (128, 8, 16), (128, 8, 64),
                 (128, 16, 8), (512, 4, 128), (384, 6, 64)]


@pytest.mark.parametrize("mask,spread,shape", [
    pytest.param("partial", 1.0, (C, H, G), id="partial-1.0"),
    pytest.param("zero", 1.0, (C, H, G), id="zero-1.0"),
    pytest.param("ones", 12.0, (C, H, G), id="ones-12.0")] + [
    pytest.param("partial", 1.0, s, id="partial-1.0-C{}-H{}-G{}".format(*s))
    for s in _OTHER_SHAPES])
def test_slice_pool_reference_matches_jax(mask, spread, shape):
    """Masks with zeros (and an all-zero mask), and logits spread over more
    than 88 within a head — where a mean shift overflowed exp() — so that
    the exact-max shift is what keeps the weights finite; and the other
    shapes the kernels take."""
    c, h, g = shape
    ops = _slice_operands(3, mask=mask, spread=spread, shape=shape)
    jw, jtok, jnorm = _jax_slice_pool(ops)
    tw, ttok, tnorm = _torch_slice_pool(ops)
    assert tw.shape == jw.shape == (2, 256, h * g)
    assert ttok.shape == jtok.shape == (2, h, g, c // h)
    assert tnorm.shape == jnorm.shape == (2, h, g)
    if spread > 1.0:
        from gen_fvgn_tpu_torch.ops.fused_slice_attn import slice_logits
        t = {k: torch.from_numpy(v) for k, v in ops.items()}
        bf = torch.bfloat16
        s = slice_logits(t["x"].to(bf), t["wx"].to(bf), t["bx"],
                         t["wsl"].to(bf), t["bsl"]).float() \
            * t["it"][:, None]
        assert float((s.amax(-1) - s.amin(-1)).max()) > 88.0
    for a in (tw, ttok, tnorm):
        assert np.isfinite(a).all()
    np.testing.assert_allclose(tw, jw, rtol=0, atol=2.0 ** -7)
    if mask == "zero":
        assert not ttok.any() and not tnorm.any()
        assert not jtok.any() and not jnorm.any()
    else:
        _close_scaled(ttok, jtok, 1e-3)
        _close_scaled(tnorm, jnorm, 1e-3)


def test_transolver_kernel_shape_predicates():
    """The shapes the Transolver kernels take, decided the same on any
    device: exactly what the JAX package fuses up to C = 1024. K5 at every
    C % 128 == 0 up to 1024 with the hidden width 2C (JAX: `c % 128 == 0
    and hd % 128 == 0`, models/transolver.py:152, with mlp_ratio 2); K6/K7
    at every (C, H, G) with C % 128 == 0, H·G % 128 == 0 and H·D == C
    (:63-64), over a grid of heads and slices. Above C = 1024 both raise
    (the named limit), and a hidden width other than 2C is refused."""
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    for c in range(64, 1153, 64):
        assert fm.premlp_shape_ok(c, 2 * c) == (c % 128 == 0 and c <= 1024), c
    assert not fm.premlp_shape_ok(128, 128)
    for c in range(128, 1153, 128):
        for h in (1, 2, 3, 4, 5, 6, 8, 12, 16, 32, 64, 128):
            for g in (1, 2, 8, 16, 24, 32, 48, 64, 128, 256):
                fused = c % h == 0 and (h * g) % 128 == 0
                assert fused == fsa.jax_fuses_slice_pool(c, h, g)
                assert fsa.slice_pool_shape_ok(c, h, g) == (
                    fused and c <= 1024), (c, h, g)
    for shape in [(C, H, G), (256, 8, 32), (512, 8, 32)]:
        assert fsa.slice_pool_plan(*shape, False)[0] == "rows", shape
    for shape in [(128, 16, 8), (512, 4, 128), (384, 6, 64)]:
        assert fsa.slice_pool_plan(*shape, False)[0] == "generic", shape
        assert fsa.slice_pool_plan(*shape, True)[0] == "generic", shape


def test_slice_pool_shared_mask_equals_per_lane_mask_and_counts_nothing():
    """A [N] node mask shared by the batch is the [B, N] mask repeated; the
    CPU takes the plain version and launches nothing."""
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    ops = _slice_operands(4, batch=2, mask="partial")
    shared = torch.from_numpy(ops["mask"][0])
    before = fsa.LAUNCHES
    a = _torch_slice_pool(ops, mask=shared)
    b = _torch_slice_pool(dict(ops, mask=np.stack([ops["mask"][0]] * 2)))
    assert fsa.LAUNCHES == before
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- PhysicsAttention


def _module_inputs(seed, n, c, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, n, c)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[int(0.8 * n):] = 0.0              # padded tail, as the block engine
    return x, mask


def _flax_and_port(kind, hidden, dtype, seed):
    """(flax module, flax params as NumPy, port module with the same
    weights) for kind "attn" or "block"."""
    from gen_fvgn_tpu.models.transolver import (PhysicsAttention as JAttn,
                                                TransolverBlock as JBlock)
    from gen_fvgn_tpu_torch.convert import params_from_flax
    from gen_fvgn_tpu_torch.models.transolver import (PhysicsAttention,
                                                      TransolverBlock)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    jcls, tcls = (JAttn, PhysicsAttention) if kind == "attn" \
        else (JBlock, TransolverBlock)
    jm = jcls(hidden, H, G, dtype=jdt)
    x0 = jnp.zeros((256, hidden), jdt or jnp.float32)
    params = numpy_tree(jm.init(jax.random.PRNGKey(0), x0,
                                jnp.ones(256)), seed)
    tm = tcls(hidden, H, G, dtype=tdt)
    tm.load_state_dict(params_from_flax(params), strict=True)
    return jm, params, tm


def _run_both(kind, hidden, dtype, n, seed):
    jm, params, tm = _flax_and_port(kind, hidden, dtype, seed)
    x, mask = _module_inputs(seed + 1, n, hidden)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    with jax_kernels_on():
        ref = jax.vmap(lambda a: jm.apply(jp, a, jnp.asarray(mask)))(
            jnp.asarray(x, jdt))
    ref = np.asarray(ref, np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(tdt),
                 torch.from_numpy(mask).to(torch.bool))
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    return ref, out.float().numpy(), tm


def _compare(ref, got, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=_ulps(ref, 4))
        assert np.median(np.abs(got - ref)) <= _ulps(ref, 1) / 4


@pytest.mark.parametrize("kind", ["attn", "block"])
@pytest.mark.parametrize("n", [256, 512])
def test_fused_form_matches_flax(kind, n):
    """C = 128, H = 8, G = 32, bf16: the fused form on both sides (K6, and
    K5f for the block); the port's plain versions stand in for its kernels
    on the CPU."""
    from unittest import mock

    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    with mock.patch.object(fsa, "fused_slice_pool_kernel",
                           wraps=fsa.fused_slice_pool_kernel) as m_pool, \
            mock.patch.object(fm, "fused_premlp_res",
                              wraps=fm.fused_premlp_res) as m_mlp:
        ref, got, tm = _run_both(kind, C, "bfloat16", n, seed=20 + n)
    assert tm.fused(n, C) if kind == "attn" else tm.attn.fused(n, C)
    assert m_pool.call_count == 1
    assert m_mlp.call_count == (1 if kind == "block" else 0)
    _compare(ref, got, "bfloat16")


@pytest.mark.parametrize("kind", ["attn", "block"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_form_matches_flax(kind, dtype):
    """Hidden 32 (D = 4): neither kernel's conditions hold, on either
    side."""
    from unittest import mock

    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    from gen_fvgn_tpu_torch.ops import fused_slice_attn as fsa
    with mock.patch.object(fsa, "fused_slice_pool") as m_pool, \
            mock.patch.object(fm, "fused_premlp_res_parts") as m_mlp:
        ref, got, _ = _run_both(kind, 32, dtype, 200, seed=30)
    assert m_pool.call_count == 0 and m_mlp.call_count == 0
    _compare(ref, got, dtype)


def test_orthogonal_slice_kernel_and_temperature_init():
    from gen_fvgn_tpu_torch.models.transolver import PhysicsAttention
    a = PhysicsAttention(C, H, G, generator=torch.Generator().manual_seed(0))
    b = PhysicsAttention(C, H, G, generator=torch.Generator().manual_seed(0))
    w = a.in_project_slice.kernel.detach()
    assert tuple(w.shape) == (D, G)
    # [D, G] with D < G: orthonormal rows, as flax's orthogonal()
    torch.testing.assert_close(w @ w.T, torch.eye(D), rtol=0, atol=1e-5)
    assert torch.equal(w, b.in_project_slice.kernel)
    assert tuple(a.graph_temperature.shape) == (1, H, 1)
    assert bool((a.graph_temperature == 0.5).all())
    assert a.to_q.bias is None and "to_q.bias" not in a.state_dict()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transolver_layer_norm_matches_flax(dtype):
    """The plain TransolverBlock's LayerNorm against flax `nn.LayerNorm`
    (fast variance, float32 statistics): the same rounding order,
    (x − μ)·(rstd·γ) + β. What is left is the order of XLA's sums and its
    rsqrt: within 2 float32 ulps of the output scale; in bf16 at most one
    rounding flips (measured: 1 element in 38,400)."""
    from flax import linen as fnn

    from gen_fvgn_tpu_torch.models.transolver import _flax_layer_norm
    rng = np.random.default_rng(7)
    x = (2 * rng.normal(size=(4, 300, 32)) + 0.3).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    bias = (0.1 * rng.normal(size=32)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(fnn.LayerNorm(dtype=jdt).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, jdt)), np.float32)
    got = _flax_layer_norm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(scale), torch.from_numpy(bias),
                           out_dtype=tdt)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 23)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * ulp)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=_ulps(ref, 1))
        assert np.mean(got != ref) <= 1e-3
