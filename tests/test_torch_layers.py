"""The port's layers, RoPE, conv spec and ViT helpers against the JAX package.

Inputs and weights are made with numpy from a seed (weights by the JAX
package's own `init`, carried over by `convert.from_jax_params`).  Both
sides compute in fp32 on the CPU unless a test says bf16.  fp32 tolerances
are 1e-5 absolute at unit scale (the two sides differ in summation order
only); bf16 cases are held to the bf16 rounding they carry, stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.nn import layers as jl
from vist3a_tpu.nn import vit as jvit
from vist3a_tpu.ops import rope as jrope
from vist3a_tpu.stitch import conv_spec as jcs
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import layers as tl
from vist3a_tpu_torch.nn import vit as tvit
from vist3a_tpu_torch.ops import rope as trope
from vist3a_tpu_torch.stitch import conv_spec as tcs

F32_ATOL = 1e-5


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _load(module, tree):
    sd = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    module.load_state_dict(sd, strict=True)
    return module


def test_layer_norm_and_linear(rng):
    x = rng.standard_normal((3, 7, 48)).astype(np.float32) * 3 + 1
    ln = {"scale": rng.standard_normal(48).astype(np.float32),
          "bias": rng.standard_normal(48).astype(np.float32)}
    lin = jl.linear_init(jax.random.key(0), 48, 20)
    for dtype, tol in (("float32", F32_ATOL), ("bfloat16", 2 ** -6)):
        # bf16: one bf16 rounding of outputs of magnitude ≲ 4 → ≤ 2⁻⁶
        jx = jnp.asarray(x, dtype)
        tx = _t(x, getattr(torch, dtype))
        want = jl.layer_norm(ln, jx, 1e-6)
        got = tl.layer_norm(tx, _t(ln["scale"]), _t(ln["bias"]), 1e-6)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
        want = jl.linear(lin, jx)
        lin_t = _load(tl.Linear(48, 20), lin)
        got = lin_t(tx)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_gelu_policy(rng):
    """Exact erf for fp32, the tanh form for bf16 — on both sides.  The fp32
    check (1e-6) would fail for the tanh form, which is up to 4.7e-4 away
    from erf.  For bf16 the port evaluates the tanh form in fp32 and rounds
    once (within one bf16 step of the fp32 tanh form), while JAX evaluates
    it in bf16 arithmetic: there 1 + tanh(u) carries tanh's 2⁻⁹ spacing near
    −1, times 0.5·|x|, so the two are held to 2⁻⁹·|x| plus one bf16 step
    of the output (2⁻⁷ of it)."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    got32 = tl.gelu(_t(x))
    np.testing.assert_allclose(_np(got32), _np(jl.gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    tanh32 = torch.nn.functional.gelu(_t(x), approximate="tanh")
    assert (got32 - tanh32).abs().max() > 1e-4
    xb = jnp.asarray(x, jnp.bfloat16)
    x16 = np.asarray(xb, np.float32)
    got16 = _np(tl.gelu(_t(x16, torch.bfloat16)))
    assert tl.gelu(_t(x16, torch.bfloat16)).dtype == torch.bfloat16
    tanh_of_bf16 = _np(torch.nn.functional.gelu(_t(x16), approximate="tanh"))
    np.testing.assert_allclose(got16, tanh_of_bf16, atol=1e-30, rtol=2 ** -8)
    erf_of_bf16 = _np(torch.nn.functional.gelu(_t(x16)))
    assert np.abs(got16 - erf_of_bf16).max() > 1e-3      # not the erf form
    want16 = _np(jl.gelu(xb))
    assert np.all(np.abs(got16 - want16)
                  <= 2 ** -9 * np.abs(x16) + 2 ** -7 * np.abs(want16) + 1e-30)


def test_mlp(rng):
    p = jl.mlp_init(jax.random.key(1), 32, 128)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    m = _load(tl.Mlp(32, 128), p)
    np.testing.assert_allclose(_np(m(_t(x))), _np(jl.mlp(p, jnp.asarray(x))),
                               atol=F32_ATOL, rtol=0)


def _block_case(rng, dtype):
    cfg_j = jl.BlockConfig(dim=64, num_heads=4, qk_norm=True, ln_eps=1e-5,
                           layerscale=0.5, use_rope=True, attn_impl="xla")
    cfg_t = tl.BlockConfig(dim=64, num_heads=4, qk_norm=True, ln_eps=1e-5,
                           layerscale=0.5, use_rope=True)
    params = jl.block_init(jax.random.key(2), cfg_j)
    # non-trivial norms and LayerScale, so that a dropped one shows
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        jnp.float32), params)
    pos = jrope.grid_positions(3, 4, special=5)          # P = 17
    p_real, p = 17, 32
    cos, sin = jrope.rope2d_cos_sin(pos, 16, 100.0)
    cos = jnp.pad(cos, ((0, p - p_real), (0, 0)), constant_values=1.0)
    sin = jnp.pad(sin, ((0, p - p_real), (0, 0)))
    kv = np.arange(p) < p_real
    x = rng.standard_normal((2, p, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jl.block_apply(jax.tree_util.tree_map(lambda a: a.astype(jdt),
                                                 params),
                          jnp.asarray(x, jdt), cfg_j, cos, sin,
                          key_valid=jnp.asarray(kv))
    blk = _load(tl.Block(cfg_t), params).to(getattr(torch, dtype))
    got = blk(_t(x, getattr(torch, dtype)), _t(cos), _t(sin),
              key_valid=torch.from_numpy(kv))
    return _np(got)[:, :p_real], _np(want)[:, :p_real]


def test_block_apply_qknorm_layerscale_rope_mask_fp32(rng):
    got, want = _block_case(rng, "float32")
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_ATOL)


def test_block_apply_bf16(rng):
    """bf16 weights and activations: the two frameworks round at other
    places (fused vs separate bias adds, bf16 GELU arithmetic), so the
    block is held to 2⁻⁵ of its output's range — a wrong mask, RoPE or norm
    moves it by O(1)."""
    got, want = _block_case(rng, "bfloat16")
    assert np.abs(got - want).max() <= 2 ** -5 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_tables_and_apply(rng, dtype):
    """Tables in fp32 on both sides; the rotation in the activations' dtype
    (bf16: one bf16 step, 2⁻⁷ of |x|·(|cos| + |sin|) ≤ 2⁻⁶·max|x|)."""
    pos = jrope.grid_positions(5, 7, special=5)
    np.testing.assert_array_equal(trope.grid_positions(5, 7, special=5), pos)
    assert (pos[:5] == 0).all() and pos[5].tolist() == [1, 1]
    cos_j, sin_j = jrope.rope2d_cos_sin(pos, 64, 100.0)
    cos_t, sin_t = trope.rope2d_cos_sin(pos, 64, 100.0, device="cpu")
    np.testing.assert_allclose(_np(cos_t), _np(cos_j), atol=1e-7, rtol=0)
    np.testing.assert_allclose(_np(sin_t), _np(sin_j), atol=1e-7, rtol=0)
    x = rng.standard_normal((2, 3, len(pos), 64)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jrope.apply_rope2d(jnp.asarray(x, jdt), cos_j.astype(jdt),
                              sin_j.astype(jdt))
    got = trope.apply_rope2d(_t(x, tdt), cos_t.to(tdt), sin_t.to(tdt))
    assert got.dtype == tdt
    tol = F32_ATOL if dtype == "float32" else 2 ** -6 * np.abs(x).max()
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


@pytest.mark.parametrize("spec,in_ch,shape", [
    ("conv3d_k5x3x3_o24_s1x2x2_p2x1x1", 16, (1, 16, 5, 9, 9)),
    ("conv3d_k3_o8_s2_p1_d1", 4, (2, 4, 6, 7, 8)),
    ("conv2d_k3x5_o6_s1x2_p1x2_d2", 3, (2, 3, 11, 12)),
    ("conv1d_k4_o5_s2_p3", 2, (1, 2, 17)),
])
def test_conv_spec_matches(rng, spec, in_ch, shape):
    js = jcs.parse_conv_spec(spec)
    ts = tcs.parse_conv_spec(spec)
    assert (ts.dim, ts.out_channels, ts.kernel_size, ts.stride, ts.padding,
            ts.dilation) == (js.dim, js.out_channels, js.kernel_size,
                             js.stride, js.padding, js.dilation)
    params = js.init(jax.random.key(3), in_ch)
    x = rng.standard_normal(shape).astype(np.float32)
    want = js.apply(params, jnp.asarray(x))
    conv = _load(tcs.SpecConv(ts, in_ch), params)
    got = conv(_t(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["conv4d_k3_o8", "conv2d_o8", "conv2d_k3"])
def test_conv_spec_rejects(bad):
    with pytest.raises(ValueError):
        tcs.parse_conv_spec(bad)


@pytest.mark.parametrize("m,gh,gw", [(37, 32, 32), (9, 6, 6), (9, 5, 11)])
def test_interpolate_pos_embed_matches_jax_resize(rng, m, gh, gw):
    """The numpy bicubic antialias matrices against `jax.image.resize` — the
    deployed 37→32 downsample, a small non-identity one and a mixed
    down/up-sample."""
    pe = rng.standard_normal((1, 1 + m * m, 16)).astype(np.float32)
    want = jvit.interpolate_pos_embed(jnp.asarray(pe), gh, gw)
    got = tvit.interpolate_pos_embed(_t(pe), gh, gw)
    assert tuple(got.shape) == (1, 1 + gh * gw, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
    same = tvit.interpolate_pos_embed(_t(pe), m, m)
    np.testing.assert_array_equal(_np(same), pe)


def test_stacked_blocks_split_per_layer():
    """A stacked (leading layer axis) tree becomes `<stack>.<i>.` entries
    with linear weights transposed to (out, in)."""
    cfg = jl.BlockConfig(dim=16, num_heads=2, layerscale=0.1)
    tree = {"blocks": jl.stack_init(jax.random.key(4), cfg, 3)}
    sd = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    w = np.asarray(tree["blocks"]["attn"]["qkv"]["w"])
    assert w.shape == (3, 16, 48)
    for i in range(3):
        np.testing.assert_array_equal(sd[f"blocks.{i}.attn.qkv.weight"].numpy(),
                                      w[i].T)
        assert f"blocks.{i}.norm1.weight" in sd
        assert f"blocks.{i}.ls2.gamma" in sd
