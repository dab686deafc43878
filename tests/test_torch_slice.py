"""The whole slice: `forward_with_latent` of the port against the JAX package.

The tiny stitched config of the JAX package's multichip dry run (2 ViT
blocks after a chop at 2, 4 aggregator layer pairs tapped at every layer,
56² images, so P = 16 + 5 = 21 tokens padded to 32 and the masked
attention path runs).  Weights come from the JAX package's `init` and are
carried over by `convert.load_jax_params`; the latent and the images are
made with numpy from a seed.  JAX runs its inference layout
(`remat=False`); the port has only that layout.

Tolerances, relative to each output's largest magnitude:
  * fp32 trunk: 1e-3 for the Gaussians, depth and cameras — a dozen
    transformer blocks, two DPT cascades and a 4-step camera refinement,
    each side summing in its own order at fp32 rounding (observed ≤ 1e-6);
  * bf16 trunk (the deployed setting): 2⁻⁷ — the two frameworks round the
    bf16 activations at other places, and those roundings pass through the
    same dozen blocks (observed ≤ 8e-4); a wrong mask, layout or weight
    moves outputs by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn.aggregator import AggregatorConfig as JAggCfg
from vist3a_tpu.nn.heads import (CameraHeadConfig as JCamCfg,
                                 DPTConfig as JDPTCfg,
                                 GSHeadConfig as JGSCfg)
from vist3a_tpu.nn.vit import ViTConfig as JViTCfg
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import aggregator as tagg
from vist3a_tpu_torch.nn import encoder as tenc
from vist3a_tpu_torch.nn import heads as th
from vist3a_tpu_torch.nn import vit as tvit
from vist3a_tpu_torch.stitch import chopped_anysplat as tca

D = 32
SPEC = f"conv3d_k5x3x3_o{D}_s1x2x2_p2x1x1"
T_VAE, IMG = 2, 56
S = (T_VAE - 1) * 4 + 1
CAMERA_BIAS = np.array([0.05, -0.05, 0.5, 0.02, 0.03, 0.01, 0.25, 0.2, 0.2],
                       np.float32)


def _configs():
    def enc(EncoderConfig, ViTConfig, AggregatorConfig, CameraHeadConfig,
            DPTConfig, GSHeadConfig):
        return EncoderConfig(
            vit=ViTConfig(img_size=56, embed_dim=D, depth=4, num_heads=2),
            agg=AggregatorConfig(embed_dim=D, depth=4, num_heads=2,
                                 taps=(0, 1, 2, 3)),
            camera=CameraHeadConfig(dim_in=2 * D, trunk_depth=1, num_heads=2),
            depth=DPTConfig(dim_in=2 * D, features=16,
                            out_channels=(8, 16, 16, 16), head2_features=8),
            gs=GSHeadConfig(dim_in=2 * D, features=16,
                            out_channels=(8, 16, 16, 16), output_dim=84,
                            head2_features=16, pos_embed=False))

    jcfg = jca.StitchedConfig(
        encoder=enc(jenc.EncoderConfig, JViTCfg, JAggCfg, JCamCfg, JDPTCfg,
                    JGSCfg), stitch_layer_index=2, conv_spec=SPEC)
    tcfg = tca.StitchedConfig(
        encoder=enc(tenc.EncoderConfig, tvit.ViTConfig,
                    tagg.AggregatorConfig, th.CameraHeadConfig, th.DPTConfig,
                    th.GSHeadConfig), stitch_layer_index=2, conv_spec=SPEC)
    return jcfg, tcfg


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((1, 16, T_VAE, IMG // 8, IMG // 8)
                                 ).astype(np.float32)
    images = rng.uniform(-1, 1, (1, 3, S, IMG, IMG)).astype(np.float32)
    return latent, images


def _run_both(trunk_bf16: bool):
    jcfg, tcfg = _configs()
    params = {"encoder": jenc.init(jax.random.key(0), jcfg.encoder),
              "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg)}
    # Random weights leave the pose near zero: a near-zero quaternion and a
    # field of view that the ReLU clips to 0 make the cameras constant or
    # ill-conditioned.  A pose-branch bias puts them at a real camera
    # (4 refinements × bias: unit-ish quaternion, FoV ≈ 0.8 rad).
    params["encoder"]["camera_head"]["pose_branch"]["fc2"]["b"] = \
        jnp.asarray(CAMERA_BIAS)
    if trunk_bf16:
        params["encoder"] = jenc.cast_trunk_bf16(params["encoder"])
    latent, images = _inputs()
    want = jca.forward_with_latent(params, jnp.asarray(latent),
                                   jnp.asarray(images), jcfg, remat=False)
    model = tca.StitchedDecoder(tcfg)
    convert.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    model.eval()
    if trunk_bf16:
        tenc.cast_trunk_bf16(model.encoder)
        assert model.encoder.aggregator.camera_token.dtype == torch.bfloat16
        assert model.encoder.depth_head.norm.weight.dtype == torch.float32
    got = tca.forward_with_latent(model, torch.from_numpy(latent),
                                  torch.from_numpy(images), tcfg,
                                  device="cpu")
    return got, want


def _rel_err(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fields(out):
    g = out.gaussians
    return {"means": g.means, "covariances": g.covariances,
            "harmonics": g.harmonics, "opacities": g.opacities,
            "depth": out.depth, "depth_conf": out.depth_conf,
            "extrinsic_c2w": out.extrinsic_c2w,
            "intrinsic_norm": out.intrinsic_norm,
            "pose_enc": out.pred_pose_enc_list[-1]}


@pytest.fixture(scope="module")
def fp32_run():
    return _run_both(trunk_bf16=False)


@pytest.mark.parametrize("name", ["means", "covariances", "harmonics",
                                  "opacities", "depth", "depth_conf",
                                  "extrinsic_c2w", "intrinsic_norm",
                                  "pose_enc"])
def test_forward_with_latent_fp32(fp32_run, name):
    got, want = fp32_run
    assert _rel_err(_fields(got)[name], _fields(want)[name]) <= 1e-3


def test_forward_with_latent_fp32_mask_and_count(fp32_run):
    got, want = fp32_run
    n = S * IMG * IMG
    assert tuple(got.gaussians.means.shape) == (1, n, 3)
    np.testing.assert_array_equal(got.conf_valid_mask.numpy(),
                                  np.asarray(want.conf_valid_mask))
    assert got.conf_valid_mask.float().mean().item() == pytest.approx(0.9,
                                                                      abs=1e-3)
    k = got.intrinsic_norm[0, :, 0, 0]          # fx / W: a real camera
    assert bool(((k > 0.3) & (k < 3)).all()), k
    np.testing.assert_allclose(got.scene_scale.item(),
                               float(want.scene_scale), rtol=1e-4)


def test_forward_with_latent_bf16_trunk():
    got, want = _run_both(trunk_bf16=True)
    errs = {k: _rel_err(v, _fields(want)[k])
            for k, v in _fields(got).items() if k != "opacities"}
    assert max(errs.values()) <= 2 ** -7, errs
    # the 10 % confidence quantile may move a few pixels across it
    mask_agree = (got.conf_valid_mask.numpy()
                  == np.asarray(want.conf_valid_mask)).mean()
    assert mask_agree >= 0.99


def test_padded_trunk_equals_unpadded(rng, monkeypatch):
    """The port's padded-token layout (P 21 → 32, masked pad keys, RoPE cos
    1 / sin 0) gives the same taps as running the 21 tokens unpadded."""
    _, tcfg = _configs()
    acfg = tcfg.encoder.agg
    agg = tagg.Aggregator(acfg)
    gen = torch.Generator().manual_seed(0)
    for p in agg.parameters():
        torch.nn.init.normal_(p, std=0.3, generator=gen)
    tokens = torch.from_numpy(rng.standard_normal((1, 3, 21, D))
                              .astype(np.float32))
    _, taps = tagg.run_trunk(agg, tokens, acfg, (4, 4))
    monkeypatch.setattr(tagg, "TOKEN_ALIGN", 1)      # 21 % 1 == 0: no pad
    _, taps_unpadded = tagg.run_trunk(agg, tokens, acfg, (4, 4))
    for a, b in zip(taps, taps_unpadded):
        assert a.shape == (1, 3, 21, 2 * D)
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_port_init_has_the_jax_shapes_and_scales():
    """The port's own initialiser (what the card runs, with no JAX there)
    makes every parameter the JAX `init` makes, at the same shape, and
    draws from the same distributions: truncated-normal linears of σ 0.02,
    unit LayerNorm scales, LayerScale constants, uniform ±1/√fan_in convs."""
    jcfg, tcfg = _configs()
    params = {"encoder": jenc.init(jax.random.key(0), jcfg.encoder),
              "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg)}
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    model = tca.init(tcfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.bfloat16)
    got = model.state_dict()
    kept = {k: v for k, v in want.items() if k in got}
    assert set(got) == set(kept)
    assert len(want) - len(kept) == sum(
        k.startswith(("encoder.vit.patch_proj.", "encoder.vit.mask_token",
                      "encoder.vit.blocks.0.", "encoder.vit.blocks.1."))
        for k in want)
    for k, v in kept.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        want_dtype = (torch.float32 if "head" in k or k.startswith(
            "stitch_conv") else torch.bfloat16)
        assert got[k].dtype == want_dtype, k
    qkv = got["encoder.aggregator.frame_blocks.0.attn.qkv.weight"].float()
    assert abs(qkv.std().item() - 0.02 * 0.8796) < 2e-3  # σ of N(0,1)|±2
    assert qkv.abs().max().item() <= 0.04 + 1e-3
    assert torch.all(got["encoder.aggregator.frame_blocks.0.ls1.gamma"]
                     == torch.tensor(0.01, dtype=torch.bfloat16))
    conv = got["encoder.depth_head.layer_rn.0.weight"]
    bound = 1 / np.sqrt(np.prod(conv.shape[1:]))
    assert conv.abs().max().item() <= bound
    assert conv.abs().max().item() > 0.9 * bound
