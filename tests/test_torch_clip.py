"""The port's CLIP vision tower and the reward's preprocesses against the
JAX package's.

The tiny tower of `tests/test_vdm_training.py` (width 32, 2 layers of 4
heads, patch 8, 32² images, projection 16), weights from the JAX `init`
carried over by `convert.load_jax_clip_vision_params`; images made with
numpy from a seed.

Tolerances:
  * features and their gradient with respect to the pixels: 1e-5 of the
    largest (fp32 on both sides, sums in another order; observed ≤ 5e-7);
  * the preprocesses: 5e-5 absolute on CLIP-normalised values (~±2).
    `jax.image.resize` and `F.interpolate(antialias=True)` both scale the
    kernel by the shrink factor — Keys' cubic a = −0.5 for the bicubic,
    the triangle for the bilinear — and differ by fp32 rounding at the
    deployed 448² → 224² and 448² → 378², at a non-square input (the short
    side scaled up to 224 and the long side centre-cropped; observed
    ≤ 2.2e-5, at 2 of 301,056 values) and at a small shrink.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.nn import clip as jclip
from vist3a_tpu.train import reward as jrew
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import clip as tclip
from vist3a_tpu_torch.train import reward as trew

CL = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
          patch_size=8, image_size=32, projection_dim=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = jclip.CLIPVisionConfig(**CL), tclip.CLIPVisionConfig(**CL)
    params = jclip.init(jax.random.key(0), jcfg)
    model = convert.load_jax_clip_vision_params(
        tclip.CLIPVision(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model.requires_grad_(False)


def test_configs_match_jax():
    for name in ("CLIP_H_224", "DFN5B_H_378"):
        assert dataclasses_asdict(getattr(tclip, name)) == \
            dataclasses_asdict(getattr(jclip, name))
    assert tclip.CLIP_MEAN == jclip.CLIP_MEAN
    assert tclip.CLIP_STD == jclip.CLIP_STD


def dataclasses_asdict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


def test_random_init_shapes_match_jax():
    tcfg = tclip.CLIPVisionConfig(**CL)
    model = tclip.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat = convert.from_jax_params({k: v for k, v in jax.tree_util.tree_map(
        np.asarray, jclip.init(jax.random.key(0), jclip.CLIPVisionConfig(
            **CL))).items() if k != "patch"})
    own = dict(model.named_parameters())
    assert set(own) == set(flat) | {"patch"}
    assert all(own[k].shape == v.shape for k, v in flat.items())
    assert float(model.layers[0].q.weight.std()) == pytest.approx(
        CL["hidden_size"] ** -0.5, rel=0.2)


def test_image_features_and_gradient_match_jax(towers):
    jcfg, params, model = towers
    rng = np.random.default_rng(1)
    pixels = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    w = rng.standard_normal((3, 16)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jclip.image_features(params, x, jcfg) * w)
    want_f = jclip.image_features(params, jnp.asarray(pixels), jcfg)
    want_g = jax.grad(jloss)(jnp.asarray(pixels))
    x = torch.from_numpy(pixels).requires_grad_()
    feats = tclip.image_features(model, x)
    (feats * torch.from_numpy(w)).sum().backward()
    assert _rel(feats, want_f) <= 1e-5
    assert _rel(x.grad, want_g) <= 1e-5
    norms = torch.linalg.vector_norm(feats, dim=-1)
    torch.testing.assert_close(norms, torch.ones(3))


@pytest.mark.parametrize("hw,size", [((448, 448), 224), ((96, 160), 224),
                                     ((40, 40), 32)])
def test_pickscore_preprocess_matches_jax(hw, size):
    im = np.random.default_rng(2).uniform(-1.1, 1.1, (2, 3, *hw)).astype(
        np.float32)
    want = jrew.pickscore_preprocess(jnp.asarray(im), size)
    got = trew.pickscore_preprocess(torch.from_numpy(im), size)
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("hw,size", [((448, 448), 378), ((72, 56), 48)])
def test_peclip_preprocess_matches_jax(hw, size):
    im = np.random.default_rng(3).uniform(-1, 1, (2, 3, *hw)).astype(
        np.float32)
    want = jrew.peclip_preprocess(jnp.asarray(im), size)
    got = trew.peclip_preprocess(torch.from_numpy(im), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
