"""PyTorch port, kernels K2/K4f's module: the plain versions
`fused_mlp_ln_reference` (three variants) and `fused_mlp_noln_reference`
against the JAX package's `fused_mlp_ln_parts` / `fused_mlp_noln_parts`,
which run their Pallas kernels in interpret mode on the CPU (as
tests/test_fused_mlp.py does). bf16 stream; tolerance 2 bf16 ulps of the
output scale: both sides round h1, h2 and the output to bf16 at the same
points, but accumulate their float32 sums in a different order, which can
move such a rounding by one step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

M, H = 300, 128          # M deliberately not a multiple of the JAX row tile


def _ulps(ref, n=2):
    scale = float(np.abs(ref).max())
    return n * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _weights(seed, k_total, d_out=H, h=H):
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        w1=g(k_total, h) / np.sqrt(max(k_total, 1)), b1=0.1 * g(h),
        w2=g(h, h) / np.sqrt(h), b2=0.1 * g(h),
        w3=g(h, d_out) / np.sqrt(h), b3=0.1 * g(d_out),
        gamma=1.0 + 0.1 * g(d_out), beta=0.1 * g(d_out))


def _run_both(parts, pres, w, w1_rows, res_idx, res_dual):
    from gen_fvgn_tpu.ops.fused_mlp import fused_mlp_ln_parts as jfn
    from gen_fvgn_tpu_torch.ops.fused_mlp import fused_mlp_ln_parts as tfn
    order = ("w1", "b1", "w2", "b2", "w3", "b3", "gamma", "beta")
    jout = jfn([jnp.asarray(p) for p in parts],
               *[jnp.asarray(w[k]) for k in order], dtype=jnp.bfloat16,
               pres=tuple(jnp.asarray(p, jnp.bfloat16) for p in pres),
               w1_rows=w1_rows, res_idx=res_idx, res_dual=res_dual)
    tout = tfn([torch.from_numpy(p) for p in parts],
               *[torch.from_numpy(w[k]) for k in order], dtype=torch.bfloat16,
               pres=tuple(torch.from_numpy(p).to(torch.bfloat16)
                          for p in pres),
               w1_rows=w1_rows, res_idx=res_idx, res_dual=res_dual)
    as_list = lambda o: list(o) if isinstance(o, tuple) else [o]
    return ([np.asarray(o, np.float32) for o in as_list(jout)],
            [o.float().numpy() for o in as_list(tout)])


def _compare(jouts, touts):
    assert len(jouts) == len(touts)
    for ref, got in zip(jouts, touts):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=_ulps(ref))
        # and nearly all entries agree to the bit
        assert (got == ref).mean() > 0.98


def _pres_only(h):
    """The encoders' form: no parts, one pre-projected input."""
    rng = np.random.default_rng(0)
    pre = rng.normal(size=(M, h)).astype(np.float32)
    w = _weights(1, 12, d_out=h, h=h)
    _compare(*_run_both([], [pre], w, [], None, False))


def _edge(h):
    """The edge MLP: part (edge_attr,) whose W1 rows are the last h of a
    3h-row kernel, one pre, residual on part 0, dual output."""
    rng = np.random.default_rng(2)
    edge = rng.normal(size=(M, h)).astype(np.float32)
    pre = rng.normal(size=(M, h)).astype(np.float32)
    w = _weights(3, 3 * h, d_out=h, h=h)
    jouts, touts = _run_both([edge], [pre], w, [(2 * h, 3 * h)], 0, True)
    assert len(touts) == 2
    _compare(jouts, touts)


def _node(h):
    """The node MLP: parts (nbr_avg [h/2], node_x [h]), residual on part 1,
    one output out + node_x."""
    rng = np.random.default_rng(4)
    nbr = rng.normal(size=(M, h // 2)).astype(np.float32)
    node = rng.normal(size=(M, h)).astype(np.float32)
    w = _weights(5, h // 2 + h, d_out=h, h=h)
    _compare(*_run_both([nbr, node], [], w, None, 1, False))


def _noln(h):
    """The decoder chain: [M, h] bf16 -> [M, 3] bf16."""
    from gen_fvgn_tpu.ops.fused_mlp import fused_mlp_noln_parts as jfn
    from gen_fvgn_tpu_torch.ops.fused_mlp import fused_mlp_noln_parts as tfn
    rng = np.random.default_rng(6)
    x = rng.normal(size=(M, h)).astype(np.float32)
    w = _weights(7, h, d_out=3, h=h)
    order = ("w1", "b1", "w2", "b2", "w3", "b3")
    ref = np.asarray(jfn(jnp.asarray(x), *[jnp.asarray(w[k]) for k in order],
                         dtype=jnp.bfloat16), np.float32)
    got = tfn(torch.from_numpy(x), *[torch.from_numpy(w[k]) for k in order],
              dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, 3)
    _compare([ref], [got.float().numpy()])


def test_pres_only_variant_matches_jax():
    _pres_only(H)


def test_edge_variant_matches_jax():
    _edge(H)


def test_node_variant_matches_jax():
    """parts 64 + 128 wide."""
    _node(H)


def test_noln_matches_jax():
    _noln(H)


@pytest.mark.parametrize("form", ["pres_only", "edge", "node", "noln"])
def test_variants_match_jax_at_hidden_256(form):
    """The same four forms at hidden width 256 (JAX fuses any multiple of
    128): the node MLP's parts are 128 + 256 wide, the decoder's input
    256."""
    {"pres_only": _pres_only, "edge": _edge, "node": _node,
     "noln": _noln}[form](256)


def test_residual_is_added_after_the_bf16_rounding():
    """out + res is a bf16 add of the ROUNDED out (dual outputs differ by
    exactly that add)."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import fused_mlp_ln_parts
    rng = np.random.default_rng(8)
    edge = torch.from_numpy(rng.normal(size=(64, H)).astype(np.float32))
    w = {k: torch.from_numpy(v) for k, v in _weights(9, H).items()}
    out, summed = fused_mlp_ln_parts(
        [edge], w["w1"], w["b1"], w["w2"], w["b2"], w["w3"], w["b3"],
        w["gamma"], w["beta"], res_idx=0, res_dual=True)
    assert torch.equal(summed, out + edge.to(torch.bfloat16))


def test_wrappers_on_cpu_are_the_references_and_count_nothing():
    from gen_fvgn_tpu_torch.ops import fused_mlp as mod
    rng = np.random.default_rng(10)
    bf = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, w1, w2, w3 = bf(32, H), bf(H, H), bf(H, H), bf(H, H)
    b1, b2, b3, ga, be = f32(H), f32(H), f32(H), f32(H), f32(H)
    before = (mod.LAUNCHES_LN, mod.LAUNCHES_NOLN)
    a = mod.fused_mlp_ln([x], [w1], b1, w2, b2, w3, b3, ga, be)
    b = mod.fused_mlp_noln(x, w1, b1, w2, b2, w3[:, :3].contiguous(), b3[:3])
    assert (mod.LAUNCHES_LN, mod.LAUNCHES_NOLN) == before
    assert torch.equal(a, mod.fused_mlp_ln_reference(
        [x], [w1], b1, w2, b2, w3, b3, ga, be))
    assert torch.equal(b, mod.fused_mlp_noln_reference(
        x, w1, b1, w2, b2, w3[:, :3].contiguous(), b3[:3]))


@pytest.mark.parametrize("h,widths,d_out,takes", [
    pytest.param(256, [256], 256, True, id="h256-part-256"),
    pytest.param(256, [256, 384], 256, True, id="h256-parts-256-384"),
    pytest.param(256, [128, 256], 256, True, id="h256-node-parts"),
    pytest.param(128, [64, 128], 128, True, id="h128-node-parts"),
    pytest.param(192, [192], 192, False, id="h192"),
    pytest.param(256, [136], 256, False, id="part-136"),
    pytest.param(256, [256], 128, False, id="ln-width-not-h")])
def test_mlp_operands_take_the_widths_jax_fuses(h, widths, d_out, takes):
    """The kernels' shape checks (`_mlp_operands`): any hidden width that
    is a multiple of 128 with the LayerNorm as wide, part widths that are
    multiples of 16 below 128 or of 128; everything else raises."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import _mlp_operands
    bf, f32 = torch.bfloat16, torch.float32
    m = 8
    parts = [torch.zeros(m, w, dtype=bf) for w in widths]
    w1s = [torch.zeros(w, h, dtype=bf) for w in widths]
    args = (parts, w1s, torch.zeros(h, dtype=f32), torch.zeros(h, h, dtype=bf),
            torch.zeros(h, dtype=f32), torch.zeros(h, d_out, dtype=bf),
            torch.zeros(d_out, dtype=f32), torch.zeros(h, dtype=f32), [], None,
            True, "test")
    if takes:
        out = _mlp_operands(*args)
        assert out[-1] == h and out[-3] == widths
        assert tuple(out[2].shape) == (sum(widths), h)
    else:
        with pytest.raises(NotImplementedError):
            _mlp_operands(*args)


# every fused MLP form the nets launch, with the kernels the library's
# plan gives it (forward, backward): the block engine's edge MLP (a 128-wide
# part and the gathered pre) and node MLP (parts 64 + 128), the segment
# engine's edge MLP (one 384-wide part: the warpgroup kernels both ways)
# and node MLP (one 192-wide part padded to 256): every backward at hidden
# 128 with a first layer on the warpgroup kernel (faster there), every
# forward where the rows fit on the rows; the encoders' pres-only form, the
# decoder (no LayerNorm), and hidden width 256 (the tiles)
_NET_FORMS = [
    ("block-edge", [128], 128, True, True, "rows", "wg"),
    ("block-node", [64, 128], 128, False, True, "rows", "wg"),
    ("segment-edge-384", [384], 128, False, True, "wg", "wg"),
    ("segment-node-256", [256], 128, False, True, "rows", "wg"),
    ("encoders-pre-only", [], 128, True, True, "rows", "rows"),
    ("decoder", [128], 128, False, False, "rows", "rows"),
    ("block-edge-h256", [256], 256, True, True, "tiles", "tiles"),
    ("segment-edge-h256", [768], 256, False, True, "tiles", "tiles"),
]


@pytest.mark.parametrize("widths,h,pre,ln,fwd,bwd",
                         [f[1:] for f in _NET_FORMS],
                         ids=[f[0] for f in _NET_FORMS])
def test_mlp_plan_names_the_kernels_of_every_net_form(widths, h, pre, ln,
                                                      fwd, bwd):
    """`mlp_plan`, the mirror of csrc/fused_mlp.cu's `make_plan` (the card
    tests and chip_smoke.py hold it against the library's own answer):
    the form of every MLP the nets launch, and its shared memory within a
    block's 232,448 bytes."""
    from gen_fvgn_tpu_torch.ops.fused_mlp import SMEM_PER_BLOCK, mlp_plan
    for bwd_, want in ((False, fwd), (True, bwd)):
        form, smem = mlp_plan(widths, h, pre, ln, bwd_)
        assert form == want
        assert 0 < smem <= SMEM_PER_BLOCK


def test_mlp_plan_layouts():
    """The plan's byte counts at the segment edge MLP's form, which the
    warpgroup kernels were written for: the rows' layout of the 384-wide
    part does not fit
    (276,992 B forward, 297,472 backward), the warpgroup layout does
    (weights 163,840 B, 4 or 2 x pieces of 2 KB a warp, the backward's
    column sums, 1 KB of alignment); no kernel takes parts the kernels'
    widths refuse."""
    from gen_fvgn_tpu_torch.ops import fused_mlp as fm
    assert fm._mlp_rows_bytes(384, 128, False, True, False) == 276_992
    assert fm._mlp_rows_bytes(384, 128, False, True, True) == 297_472
    assert fm.mlp_plan([384], 128, False, True, False) == ("wg", 230_400)
    assert fm.mlp_plan([384], 128, False, True, True) == ("wg", 220_160)
    # a first layer too wide for the warpgroup layout too: the tiles
    assert fm.mlp_plan([512], 128, False, True, False)[0] == "tiles"
    # no LayerNorm (K4f/K4b) never takes the warpgroup kernels
    assert fm.mlp_plan([256, 256], 128, False, False, False)[0] == "tiles"
    for widths, h in (([136], 256), ([40], 128), ([128], 192), ([], 128)):
        assert fm.mlp_plan(widths, h, False, True, False) is None
    assert fm.MLP_FORMS == ("rows", "wg", "tiles")
