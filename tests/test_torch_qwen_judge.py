"""The port's judge (`vist3a_tpu_torch/eval/qwen_judge.py`) against the JAX
package's `vist3a_tpu/eval/qwen_judge.py` and Pillow, on the CPU.

  * `eval/re10k.py::bicubic_resize` (Pillow's 8-bit two-pass bicubic in
    numpy) equals `PIL.Image.resize(..., Image.BICUBIC)` byte for byte over
    down- and up-scales, odd sizes and one axis kept, on random and smooth
    images (`test_lanczos_equals_pillow` keeps the Lanczos callers');
  * `preprocess_image` (the smart-resize grid, the bicubic, the CLIP
    normalisation, the merge-group order) equals JAX's exactly;
  * `build_chat_ids` equals JAX's with `tests.test_qwen_judge.StubTokenizer`;
  * the VQA and UnifiedReward judges give JAX's strings at the tiny configs
    of `tests/test_qwen_vl.py`;
  * `load_judge` of an HF-layout folder (config.json, two safetensors
    shards, fabricated from the port's modules under either key prefix)
    gives JAX's configs and weights.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from test_qwen_judge import StubTokenizer
from test_torch_qwen_vl import (TT, TV, jax_judge_params,  # noqa: F401
                                one_torch_thread, port_judge)
from test_qwen_vl import TCFG, VCFG
from test_torch_re10k import _image
from vist3a_tpu.eval import qwen_judge as jjudge
from vist3a_tpu.nn import qwen_vl as jq
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.eval import qwen_judge as tjudge
from vist3a_tpu_torch.eval import re10k as tre
from vist3a_tpu_torch.io import manifests as tmf
from vist3a_tpu_torch.nn import qwen_vl as tq

BICUBIC_SIZES = [((120, 200), (196, 112)), ((448, 448), (224, 224)),
                 ((37, 53), (20, 11)), ((37, 53), (101, 77)),
                 ((7, 9), (3, 30)), ((64, 64), (64, 30)),
                 ((100, 33), (33, 100)), ((1, 5), (3, 1)),
                 ((360, 640), (644, 364))]


@pytest.fixture(scope="module")
def params():
    return jax_judge_params()


@pytest.fixture(scope="module")
def modules(params):
    return port_judge(params)


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("hw,size", BICUBIC_SIZES)
def test_bicubic_equals_pillow(hw, size, kind):
    img = _image(hw, kind)
    want = np.asarray(Image.fromarray(img).resize(size,
                                                  resample=Image.BICUBIC))
    got = tre.bicubic_resize(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,pixels", [
    ((120, 200), (56 * 56, 14 * 14 * 4 * 1280)),   # up to the 28-px grid
    ((448, 448), (56 * 56, 14 * 14 * 4 * 1280)),   # the orbit frames: as is
    ((1080, 1920), (56 * 56, 14 * 14 * 4 * 1280)),  # over the pixel budget
    ((30, 20), (56 * 56, 14 * 14 * 4 * 1280)),     # under the minimum
    ((8, 8), (16, 64))])                            # the tiny judge's
def test_preprocess_image_equals_jax(hw, pixels):
    img = _image(hw, 0, seed=5)
    for cfg in (jq.QWEN25_VL_7B_VISION, VCFG):
        want, wgrid = jjudge.preprocess_image(img, cfg, min_pixels=pixels[0],
                                              max_pixels=pixels[1])
        tcfg = tq.QWEN25_VL_7B_VISION if cfg is jq.QWEN25_VL_7B_VISION \
            else TV
        got, grid = tjudge.preprocess_image(img, tcfg, min_pixels=pixels[0],
                                            max_pixels=pixels[1])
        assert grid == wgrid
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="uint8"):
        tjudge.preprocess_image(img.astype(np.float32), TV)


def test_build_chat_ids_equals_jax():
    tok = StubTokenizer()
    for question, n in (("is there a cat?", 16), (tjudge.VQA_WRAPPER.format(
            question="is the chair red?"), 256)):
        np.testing.assert_array_equal(
            tjudge.build_chat_ids(tok, question, n),
            jjudge.build_chat_ids(tok, question, n))
    assert tjudge.VQA_WRAPPER == jjudge.VQA_WRAPPER
    assert tjudge.UNIFIED_REWARD_PROMPT == jjudge.UNIFIED_REWARD_PROMPT


@pytest.mark.parametrize("hw", [(8, 8), (20, 12)])
def test_judges_equal_jax(params, modules, hw):
    """Both callables at the tiny configs: the same greedy tokens, so the
    same decoded strings."""
    img = np.random.default_rng(1).integers(0, 255, (*hw, 3)).astype(
        np.uint8)
    kw = dict(max_new_tokens=4, min_pixels=16, max_pixels=64)
    vis, txt = params
    tok = StubTokenizer()
    want_vqa = jjudge.make_vqa_judge(vis, txt, tok, vcfg=VCFG, tcfg=TCFG,
                                     **kw)(img, "is there a cat?")
    want_ur = jjudge.make_unified_reward_judge(
        vis, txt, tok, vcfg=VCFG, tcfg=TCFG, **kw)([img], "a photo of a cat")
    got_vqa = tjudge.make_vqa_judge(*modules, tok, **kw)(img,
                                                         "is there a cat?")
    got_ur = tjudge.make_unified_reward_judge(*modules, tok, **kw)(
        [img], "a photo of a cat")
    assert (got_vqa, got_ur) == (want_vqa, want_ur)
    assert got_vqa.startswith("t") and len(got_vqa.split()) == 4


def write_judge_folder(folder, modules, *, legacy: bool = False):
    """The port's judge modules as an HF folder (phase `generation`'s
    writers): config.json and two safetensors shards with their index."""
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "config.json").write_text(json.dumps(
        chip_smoke.qwen_config_json(modules[0].cfg, modules[1].cfg,
                                    "float32")))
    chip_smoke.write_sharded(folder, tmf._fab_qwen_vl(*modules,
                                                      legacy=legacy), 2)
    return folder


@pytest.mark.parametrize("legacy", [False, True])
def test_load_judge_matches_jax(modules, tmp_path, legacy):
    folder = write_judge_folder(tmp_path / "judge", modules, legacy=legacy)
    tok = StubTokenizer()
    jvis, jtxt, jtok, jv, jt = jjudge.load_judge(str(folder), tokenizer=tok)
    vis, txt, ttok, tv, tt = tjudge.load_judge(str(folder), tokenizer=tok,
                                               device="cpu")
    assert ttok is tok and jtok is tok
    assert (tv, tt) == (TV, TT)
    assert (tv.__dict__, tt.__dict__) == (jv.__dict__, jt.__dict__)
    for mod, tree, load in (
            (vis, jvis, convert.load_jax_qwen_vision_params),
            (txt, jtxt, convert.load_jax_qwen_text_params)):
        want = load(type(mod)(mod.cfg), jax.tree.map(np.asarray, tree))
        for k, v in want.state_dict().items():
            assert torch.equal(mod.state_dict()[k], v), k
