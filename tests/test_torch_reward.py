"""The port's reward (`train/reward.py`) against the JAX package's.

The tiny stitched decoder of `tests/test_torch_slice.py` (56² images,
5 views), the tiny CLIP towers of `tests/test_vdm_training.py` for both
scorers, weights from the JAX `init` carried over by `convert`; latents,
video and text features made with numpy from a seed.  JAX runs the
stitched decoder in its training layout and the rasterizer's Pallas
composite and VJP in interpret mode; the port its plain attention and the
composite's plain versions (the kernels are held against those on the
card).  The JAX draws (view permutation, decoded frame) come from its key
and are handed to the port.

Tolerances, relative to the largest magnitude of what is compared:
  * `make_loss_fn`'s loss, mixed score and scores: 1e-5 (fp32);
  * `calculate_reward`'s value: 1e-5 (observed 1.3e-7); its gradients with
    respect to the latents and the video: 2e-4 (observed 2.3e-5 and
    4.6e-6).  They pass the stitched decoder's backward, the renders'
    composite backward and the towers; the JAX rasterizer takes T through
    a log-space prefix sum and its per-Gaussian sums as an fp32 prefix
    difference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import CAMERA_BIAS, _configs
from vist3a_tpu.nn import clip as jclip
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu.train import reward as jrew
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import clip as tclip
from vist3a_tpu_torch.stitch import chopped_anysplat as tca
from vist3a_tpu_torch.train import reward as trew

CL = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
          patch_size=8, image_size=32, projection_dim=16)
IMG = 56


def T(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jccfg, tccfg = jclip.CLIPVisionConfig(**CL), tclip.CLIPVisionConfig(**CL)
    pick, pe = (jclip.init(jax.random.key(i), jccfg) for i in (4, 5))
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 16)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    jl = jrew.make_loss_fn(pick, pe, logit_scale=100.0,
                           cfg=jrew.RewardConfig(pick_cfg=jccfg,
                                                 pe_cfg=jccfg))
    towers = [convert.load_jax_clip_vision_params(tclip.CLIPVision(tccfg),
                                                  _np(p)).requires_grad_(False)
              for p in (pick, pe)]
    tl = trew.make_loss_fn(*towers, logit_scale=100.0,
                           cfg=trew.RewardConfig(pick_cfg=tccfg,
                                                 pe_cfg=tccfg))
    return dict(jl=jl, tl=tl, pick_text=text[:1], pe_text=text[1:])


def test_reward_config_matches_jax():
    assert dataclasses.asdict(trew.RewardConfig()) == \
        dataclasses.asdict(jrew.RewardConfig())


def test_loss_fn_matches_jax(setup):
    im = np.random.default_rng(1).uniform(-1, 1, (3, 3, IMG, IMG)).astype(
        np.float32)
    want = setup["jl"](jnp.asarray(im), pick_text=setup["pick_text"],
                       pe_text=setup["pe_text"])
    got = setup["tl"](T(im), pick_text=T(setup["pick_text"]),
                      pe_text=T(setup["pe_text"]))
    assert _rel(got[0], want[0]) <= 1e-5
    assert _rel(got[1], want[1]) <= 1e-5
    for k, v in want[2].items():
        assert _rel(got[2][k], v) <= 1e-5
    with pytest.raises(ValueError, match="text features"):
        setup["tl"](T(im))


def test_calculate_reward_value_and_gradients_match_jax(setup):
    jcfg, tcfg = _configs()
    params = {"encoder": jenc.init(jax.random.key(0), jcfg.encoder),
              "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg)}
    params["encoder"]["camera_head"]["pose_branch"]["fc2"]["b"] = \
        jnp.asarray(CAMERA_BIAS)
    stitched = convert.load_jax_params(tca.StitchedDecoder(tcfg),
                                       _np(params)).requires_grad_(False)
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    video = rng.uniform(-1, 1, (1, 3, 5, 64, 64)).astype(np.float32)
    feats = (setup["pick_text"], setup["pe_text"])
    key = jax.random.key(3)

    def jloss(lat, video):
        loss, _ = jrew.calculate_reward(key, lat, video, params, jcfg,
                                        setup["jl"], render_size=IMG,
                                        text_feats=feats)
        return loss
    want, (g_lat, g_vid) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1)))(jnp.asarray(lat), jnp.asarray(video))
    k_views, k_frame = jax.random.split(key)
    perm = T(jax.random.permutation(k_views, 5))
    frame = int(jax.random.randint(k_frame, (1,), 0, 5)[0])
    tlat, tvid = T(lat).requires_grad_(), T(video).requires_grad_()
    loss, (decoded, rendered) = trew.calculate_reward(
        tlat, tvid, stitched, tcfg, setup["tl"], perm=perm, frame=frame,
        render_size=IMG, text_feats=tuple(T(x) for x in feats))
    assert decoded.shape == (1, IMG, IMG, 3)
    assert rendered.shape == (5, IMG, IMG, 3)      # 13 asked, 5 predicted
    loss.backward()
    assert _rel(loss, want) <= 1e-5
    assert _rel(tlat.grad, g_lat) <= 2e-4
    assert _rel(tvid.grad, g_vid) <= 2e-4
