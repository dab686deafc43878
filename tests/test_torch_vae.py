"""The port's Wan VAE decoder and the converter's VAE subtree against JAX.

`WanVAEConfig(base_dim=8, z_dim=16, num_res_blocks=1)` (the tiny VAE of
`tests/test_t23d_pipeline.py`): decoder widths (32, 32, 32, 16, 8), two
3D upsamples and one 2D upsample, so a (1, 16, 4, 8, 8) latent becomes a
(1, 3, 13, 64, 64) video.  Weights come from the JAX `init` through
`convert.load_jax_vae_params`; the latent is made with numpy from a seed.

Tolerances (absolute; the video lies in [−1, 1]):
  * fp32: 1e-4 — ~20 convolutions summed in another order on each side
    (observed ~1e-6);
  * bf16 (the deployed decode): each package's bf16 video lies ~0.065 (max)
    and ~0.007 (mean) from the fp32 video, because every activation is
    rounded to bf16 and random weights carry those roundings through ~20
    layers.  The two bf16 videos round at other places (silu, the norm's
    rescale), so they differ by as much: max ≤ 2⁻³ and mean ≤ 2⁻⁶ between
    them, and the port's mean error against fp32 at most 1.25× the JAX
    package's.  A wrong layout or interleave moves the video by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.nn import wan_vae as jvae
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import wan_vae as tvae

JCFG = jvae.WanVAEConfig(base_dim=8, z_dim=16, num_res_blocks=1)
TCFG = tvae.WanVAEConfig(base_dim=8, z_dim=16, num_res_blocks=1)


def decoder_params(key, cfg=JCFG):
    """The decoding side of `wan_vae.init` (the encoder side's init is as
    slow again and the port holds none of it)."""
    k1, k2 = jax.random.split(key)
    return {"post_quant_conv": jvae.conv3d_init(k1, cfg.z_dim, cfg.z_dim,
                                                (1, 1, 1)),
            "decoder": jvae.decoder_init(k2, cfg)}


@pytest.fixture(scope="module")
def vae_pair():
    params = jax.jit(decoder_params)(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = tvae.WanVAEDecoder(TCFG)
    convert.load_jax_vae_params(model, params)
    return params, model.eval()


@pytest.fixture(scope="module")
def videos(vae_pair):
    """{dtype: (port video, JAX video)} for one seeded latent, in fp32."""
    params, model = vae_pair
    z = np.random.default_rng(0).standard_normal((1, 16, 4, 8, 8)) \
        .astype(np.float32)
    run = jax.jit(lambda p, z: jvae.decode(p, z, JCFG).astype(jnp.float32))
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        got = tvae.decode(model, torch.from_numpy(z).to(tdt))
        assert got.dtype == tdt
        out[name] = (got.float().numpy(),
                     np.asarray(run(params, jnp.asarray(z).astype(jdt))))
    return out


def test_decode_matches_jax_fp32(videos):
    got, want = videos["float32"]
    assert got.shape == want.shape == (1, 3, 13, 64, 64)
    assert np.abs(got).max() <= 1.0
    assert np.abs(got - want).max() <= 1e-4
    assert want.std() > 1e-2          # random weights, yet not a flat video


def test_decode_matches_jax_bf16(videos):
    got, want = videos["bfloat16"]
    ref = videos["float32"][1]
    assert got.shape == want.shape and np.abs(got).max() <= 1.0
    assert np.abs(got - want).max() <= 2 ** -3
    assert np.abs(got - want).mean() <= 2 ** -6
    assert np.abs(got - ref).mean() <= 1.25 * np.abs(want - ref).mean()


def test_upsample3d_passes_a_single_frame(vae_pair, rng):
    """T' = 1: the time conv is skipped and frame 0 passes through."""
    params, model = vae_pair
    up = params["decoder"]["up_blocks"][0]["upsamplers"][0]
    for t in (1, 3):
        x = rng.standard_normal((1, 32, t, 4, 4)).astype(np.float32)
        want = jvae.resample(up, jnp.moveaxis(jnp.asarray(x), 1, -1),
                             "upsample3d")
        got = model.decoder.up_blocks[0].upsamplers[0](torch.from_numpy(x))
        assert got.shape == (1, 16, 2 * t - 1, 8, 8)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.moveaxis(np.asarray(want), -1, 1),
                                   atol=1e-5)


def test_rms_norm_and_interleave(rng):
    x = rng.standard_normal((2, 6, 3, 4, 5)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    want = jvae.rms_norm({"gamma": jnp.asarray(gamma)},
                         jnp.moveaxis(jnp.asarray(x), 1, -1))
    got = tvae.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma))
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-6, atol=1e-6)
    want = jvae._interleave_time(jnp.moveaxis(jnp.asarray(x), 1, -1))
    got = tvae._interleave_time(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.moveaxis(np.asarray(want), -1, 1))


def test_latent_normalisation_matches_jax(rng):
    z = rng.standard_normal((1, 16, 2, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvae.unnormalize_latents(torch.from_numpy(z)).numpy(),
        np.asarray(jvae.unnormalize_latents(jnp.asarray(z))), rtol=1e-6)
    assert tvae.LATENTS_MEAN == jvae.LATENTS_MEAN
    assert tvae.LATENTS_STD == jvae.LATENTS_STD


def test_converter_is_strict_and_drops_the_encoder_side(vae_pair):
    params = dict(vae_pair[0])
    # the encoder side of the JAX tree, at its shapes (values unused)
    params["encoder"] = {"conv_in": {"kernel": np.zeros((3, 3, 3, 3, 8),
                                                        np.float32),
                                     "bias": np.zeros(8, np.float32)}}
    params["quant_conv"] = {"kernel": np.zeros((1, 1, 1, 32, 32), np.float32),
                            "bias": np.zeros(32, np.float32)}
    sd = convert.from_jax_params({"vae": params})
    own = tvae.WanVAEDecoder(TCFG).state_dict()
    kept = {k[len("vae."):] for k in sd} & set(own)
    assert kept == set(own)
    dropped = {k for k in sd if k[len("vae."):] not in own}
    assert dropped and all(k.startswith(("vae.encoder.", "vae.quant_conv."))
                           for k in dropped)
    # DHWIO → OIDHW, HWIO → OIHW, gamma → weight
    k3 = params["decoder"]["conv_in"]["kernel"]
    assert tuple(sd["vae.decoder.conv_in.weight"].shape) == (
        k3.shape[4], k3.shape[3], *k3.shape[:3])
    k2 = params["decoder"]["up_blocks"][0]["upsamplers"][0]["conv"]["kernel"]
    np.testing.assert_array_equal(
        sd["vae.decoder.up_blocks.0.upsamplers.0.conv.weight"].numpy(),
        k2.transpose(3, 2, 0, 1))
    assert "vae.decoder.norm_out.weight" in sd
    bad = dict(params)
    bad["decoder"] = dict(params["decoder"], extra={"kernel": k3})
    with pytest.raises(KeyError, match="extra"):
        convert.load_jax_vae_params(tvae.WanVAEDecoder(TCFG), bad)


def test_port_init_has_the_jax_shapes_and_scales(vae_pair):
    params = vae_pair[0]
    want = {k[len("vae."):]: v for k, v in
            convert.from_jax_params({"vae": params}).items()}
    model = tvae.init_decoder(TCFG, torch.Generator().manual_seed(0),
                              device="cpu", dtype=torch.bfloat16)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.dtype == torch.bfloat16
    w = got["decoder.mid_block.resnets.0.conv1.weight"].float()
    bound = 1 / np.sqrt(np.prod(w.shape[1:]))
    assert bound * 0.9 < w.abs().max().item() <= bound
    assert torch.all(got["decoder.norm_out.weight"] == 1)
