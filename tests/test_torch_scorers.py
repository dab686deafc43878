"""The port's scorer adapters (`vist3a_tpu_torch/eval/scorers.py`) and its
`jax.image.resize` (`ops/resize.py`) against the JAX package, fp32 on the
CPU.

  * `ops/resize.py::resize` against `jax.image.resize` for bicubic and
    bilinear, antialiased or not, up and down: within 1e-5 of the largest
    (XLA's compiled weights round some sample positions and column sums
    otherwise than any one fp32 formula: up to ~7e-6 at 56 → 500);
  * `_frames_to_clip_input` (bicubic antialiased shorter-side resize,
    centre crop, CLIP normalisation) within 1e-5, over portrait and
    landscape frames, up- and down-scaled;
  * CLIPScore, LongCLIP and the aesthetic probe on the tiny towers of
    `tests/test_scorers.py` (vision) and `tests/test_cli_rl.py` (text, here
    with quick GELU), JAX `init` weights carried by `convert`, the text
    through each package's tokenizer: within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_clip_tokenizer import MERGES, build_vocab
from test_scorers import TINY
from vist3a_tpu.data import clip_tokenizer as jtok
from vist3a_tpu.eval import scorers as js
from vist3a_tpu.nn import clip as jclip
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.data import clip_tokenizer as ttok
from vist3a_tpu_torch.eval import scorers as ts
from vist3a_tpu_torch.nn import clip as tclip
from vist3a_tpu_torch.ops.resize import resize

INPUT_ATOL = 1e-5
SCORE_RTOL = 1e-5
VOCAB = build_vocab(MERGES)
V = max(VOCAB.values()) + 1   # build_vocab has a duplicate ("a</w>")


def text_cfgs(pkg):
    base = pkg.CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=4,
                              mlp_dim=64, vocab_size=V,
                              context_length=16, projection_dim=16,
                              act="quick_gelu")
    return base, dataclasses.replace(base, context_length=24)


@pytest.fixture(scope="module")
def towers():
    """JAX trees and the port's towers holding them: vision (TINY), and a
    CLIP and a LongCLIP text tower."""
    vis = jax.jit(jclip.init, static_argnums=(1,))(jax.random.key(0), TINY)
    tvis = convert.load_jax_clip_vision_params(
        tclip.CLIPVision(tclip.CLIPVisionConfig(**TINY.__dict__)),
        jax.tree.map(np.asarray, vis)).eval()
    texts = []
    for i, (jc, tc) in enumerate(zip(text_cfgs(jclip), text_cfgs(tclip))):
        tree = jax.jit(jclip.text_init, static_argnums=(1,))(
            jax.random.key(1 + i), jc)
        tmod = convert.load_jax_clip_text_params(
            tclip.CLIPText(tc), jax.tree.map(np.asarray, tree)).eval()
        texts.append((tree, jc, tmod))
    return vis, tvis, texts


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shape", [(1, 3, 40, 56), (2, 37, 300, 3),
                                   (1, 3, 448, 448)])
def test_resize_matches_jax(method, antialias, shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    spatial = (1, 2) if shape[-1] == 3 else (2, 3)
    for size in ((17, 23), (224, 224), (90, 500)):
        out = list(shape)
        for ax, n in zip(spatial, size):
            out[ax] = n
        want = np.asarray(jax.image.resize(jnp.asarray(x), tuple(out),
                                           method, antialias=antialias))
        got = resize(torch.from_numpy(x), tuple(out), method,
                     antialias).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=INPUT_ATOL * np.abs(want).max())


@pytest.mark.parametrize("hw", [(40, 56), (56, 40), (300, 200), (200, 300),
                                (448, 448), (17, 90), (224, 224)])
def test_frames_to_clip_input_matches_jax(hw):
    frames = [np.random.default_rng(i).integers(0, 256, (*hw, 3)).astype(
        np.uint8) for i in range(2)]
    for size in (32, 224):
        want = np.asarray(js._frames_to_clip_input(frames, size))
        got = ts._frames_to_clip_input(frames, size)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=INPUT_ATOL)


def test_clip_scorers_match_jax(towers):
    vis, tvis, texts = towers
    frames = [np.random.default_rng(3 + i).integers(
        0, 255, (40 + 8 * i, 56, 3), np.uint8) for i in range(3)]
    jt = jtok.CLIPTokenizer(VOCAB, MERGES)
    tt = ttok.CLIPTokenizer(VOCAB, MERGES)
    for tree, jc, tmod in texts:
        for prompt in ("a photo of a cat", "the rendered cat's hat"):
            want_fn = js.make_clip_text_features(tree, jc, jt)
            got_fn = ts.make_clip_text_features(tmod, tt)
            np.testing.assert_allclose(got_fn(prompt).numpy(),
                                       want_fn(prompt), rtol=0,
                                       atol=SCORE_RTOL)
            want = js.make_clip_scorer(vis, want_fn, TINY)(frames, prompt)
            got = ts.make_clip_scorer(tvis, got_fn)(frames, prompt)
            assert 0.0 <= got <= 100.0
            assert abs(got - want) <= SCORE_RTOL * max(abs(want), 1.0)
    # a text direction equal to one image's features scores ~100
    img = ts._frames_to_clip_input(frames[:1], TINY.image_size)
    with torch.no_grad():
        feat = tclip.image_features(tvis, img)[0]
    assert abs(ts.make_clip_scorer(tvis, lambda p: feat)(frames[:1], "x")
               - 100.0) <= 1e-3


def test_aesthetic_scorer_matches_jax(towers):
    vis, tvis, _ = towers
    rng = np.random.default_rng(5)
    w = rng.standard_normal(16).astype(np.float32)
    frames = [rng.integers(0, 255, (32, 48, 3), np.uint8) for _ in range(2)]
    want = js.make_aesthetic_scorer(vis, w, np.float32(2.0), TINY)(frames)
    got = ts.make_aesthetic_scorer(tvis, w, np.float32(2.0))(frames)
    assert abs(got - want) <= SCORE_RTOL * abs(want)
    assert ts.CLIP_L_224 == tclip.CLIPVisionConfig(**js.CLIP_L_224.__dict__)
