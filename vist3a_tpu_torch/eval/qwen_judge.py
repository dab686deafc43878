"""The Qwen2.5-VL judge callables of the generation-evaluation harness.

Port of `vist3a_tpu/eval/qwen_judge.py`:

  * `make_vqa_judge` — DPG-Bench's chat-template VQA with the exact
    "one word 'Yes' or 'No'" wrapper, greedy decode
    (`dpg_evaluation.py:91-124`, `MPLUG.vqa`);
  * `make_unified_reward_judge` — the UnifiedReward alignment / coherence /
    style prompt (verbatim, `gen_metrics/unified_reward.py:67-133`) and a
    greedy decode; `gen_eval.parse_unified_scores` parses the answer.

The model is `nn/qwen_vl.py`.  On the host: the image resized to the
smart-resize grid by Pillow's bicubic (the HF processor's default
resample) — here `eval/re10k.py::bicubic_resize`, Pillow's 8-bit resample
in numpy, equal to it byte for byte, so Pillow is not needed — then the
CLIP mean / std and the merge-group patch order.  The vision tower runs on
the fp32 patches (the JAX judge hands it fp32 pixels, so its activations
are fp32 whatever the weights' dtype), the decoder in the weights' dtype.
The text tokenizer is `transformers.AutoTokenizer` of the checkpoint
folder unless one is handed in (`load_judge(tokenizer=...)`): an object
with `__call__(text, add_special_tokens=False)["input_ids"]` and
`decode(ids, skip_special_tokens=True)`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from vist3a_tpu_torch.eval.gen_eval import UNIFIED_REWARD_PROMPT
from vist3a_tpu_torch.eval.re10k import bicubic_resize
from vist3a_tpu_torch.io import load_weights
from vist3a_tpu_torch.io.weight_import import build_module
from vist3a_tpu_torch.nn import qwen_vl
from vist3a_tpu_torch.nn.clip import CLIP_MEAN, CLIP_STD

IM_START, IM_END = "<|im_start|>", "<|im_end|>"
VISION_START, VISION_END = "<|vision_start|>", "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"

VQA_WRAPPER = ("Please answer the following question with only one word "
               "'Yes' or 'No': {question}\nASSISTANT:\n")


def preprocess_image(img: np.ndarray, cfg: qwen_vl.QwenVLVisionConfig, *,
                     min_pixels: int = 56 * 56,
                     max_pixels: int = 14 * 14 * 4 * 1280):
    """(H, W, 3) uint8 → (flat patches, grid): smart-resize to the patch
    grid (Pillow's bicubic, the HF processor default), CLIP-normalise,
    patchify in HF merge-group order."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    factor = cfg.patch_size * cfg.spatial_merge_size
    h, w = img.shape[:2]
    rh, rw = qwen_vl.smart_resize(h, w, factor, min_pixels, max_pixels)
    arr = bicubic_resize(img, (rw, rh)).astype(np.float32) / 255.0
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    arr = (arr - mean) / std
    frames = arr.transpose(2, 0, 1)[None]          # (1, C, H, W)
    return qwen_vl.patchify(frames, cfg)


def build_chat_ids(tokenizer, question: str, n_image_tokens: int,
                   system: str = "You are a helpful assistant.") -> np.ndarray:
    """Qwen2.5-VL chat template with generation prompt; the single image
    placeholder is expanded to `n_image_tokens` pads (what
    `AutoProcessor.apply_chat_template` + processor expansion produce)."""
    text = (f"{IM_START}system\n{system}{IM_END}\n"
            f"{IM_START}user\n{VISION_START}{IMAGE_PAD * n_image_tokens}"
            f"{VISION_END}{question}{IM_END}\n"
            f"{IM_START}assistant\n")
    ids = tokenizer(text, add_special_tokens=False)["input_ids"]
    return np.asarray(ids, np.int32)


def _run(vision: qwen_vl.QwenVLVision, text: qwen_vl.QwenVLText, tokenizer,
         img, question: str, max_new_tokens: int, min_pixels: int,
         max_pixels: int) -> str:
    vcfg = vision.cfg
    patches, grid = preprocess_image(img, vcfg, min_pixels=min_pixels,
                                     max_pixels=max_pixels)
    n_img = patches.shape[0] // vcfg.spatial_merge_size ** 2
    ids = build_chat_ids(tokenizer, question, n_img)
    with torch.no_grad():
        feats = qwen_vl.vision_features(
            vision, torch.from_numpy(patches).to(vision.patch_embed.device),
            grid)
    pos, delta = qwen_vl.get_rope_index(ids, [grid], text.cfg, vcfg)
    out = qwen_vl.greedy_generate(text, ids, feats, pos, delta,
                                  max_new_tokens=max_new_tokens)
    return tokenizer.decode(out, skip_special_tokens=True).strip()


def load_judge(checkpoint_dir: str, *, tokenizer=None,
               device: torch.device | str = "cuda"):
    """A local HF-layout Qwen2.5-VL checkpoint folder (config.json +
    *.safetensors [+ tokenizer files]) → (vision tower, text decoder,
    tokenizer, vcfg, tcfg) on `device`, in the file's dtype.
    The reference does the equivalent with
    `Qwen2_5_VLForConditionalGeneration.from_pretrained`
    (`dpg_evaluation.py:82-86`, `gen_metrics/unified_reward.py:57-63`).
    Without `tokenizer`, `transformers.AutoTokenizer` reads the folder's
    tokenizer files (an ImportError where transformers is absent)."""
    folder = Path(checkpoint_dir)
    hf = json.loads((folder / "config.json").read_text())
    v = hf.get("vision_config", {})
    t = hf.get("text_config", hf)
    vcfg = qwen_vl.QwenVLVisionConfig(
        depth=v.get("depth", 32),
        hidden_size=v.get("hidden_size", 1280),
        intermediate_size=v.get("intermediate_size", 3420),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", 3),
        patch_size=v.get("patch_size", 14),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        tokens_per_second=v.get("tokens_per_second", 2),
        window_size=v.get("window_size", 112),
        out_hidden_size=v.get("out_hidden_size", 3584),
        fullatt_block_indexes=tuple(v.get("fullatt_block_indexes",
                                          (7, 15, 23, 31))))
    eos = t.get("eos_token_id", hf.get("eos_token_id", 151645))
    eos = tuple(eos) if isinstance(eos, (list, tuple)) else (eos, 151643)
    tcfg = qwen_vl.QwenVLTextConfig(
        vocab_size=t.get("vocab_size", 152064),
        hidden_size=t.get("hidden_size", 3584),
        intermediate_size=t.get("intermediate_size", 18944),
        num_layers=t.get("num_hidden_layers", 28),
        num_heads=t.get("num_attention_heads", 28),
        num_kv_heads=t.get("num_key_value_heads", 4),
        rope_theta=t.get("rope_theta", 1e6),
        mrope_section=tuple(t.get("rope_scaling", {}).get("mrope_section",
                                                          (16, 24, 24))),
        rms_eps=t.get("rms_norm_eps", 1e-6),
        tie_embeddings=t.get("tie_word_embeddings",
                             hf.get("tie_word_embeddings", False)),
        image_token_id=hf.get("image_token_id", 151655),
        video_token_id=hf.get("video_token_id", 151656),
        vision_start_token_id=hf.get("vision_start_token_id", 151652),
        eos_token_ids=eos)
    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(str(folder))
    sd = load_weights.load_sharded_safetensors(folder)
    vsd, tsd = qwen_vl.import_hf_qwen_vl(sd, vcfg, tcfg)
    del sd
    dtype = tsd["embed"].dtype
    vision = build_module(lambda: qwen_vl.QwenVLVision(vcfg), vsd,
                          device=device, dtype=dtype)
    text = build_module(lambda: qwen_vl.QwenVLText(tcfg), tsd,
                        device=device, dtype=dtype)
    return vision, text, tokenizer, vcfg, tcfg


def make_vqa_judge(vision: qwen_vl.QwenVLVision, text: qwen_vl.QwenVLText,
                   tokenizer, *, max_new_tokens: int = 16,
                   min_pixels: int = 56 * 56,
                   max_pixels: int = 14 * 14 * 4 * 1280):
    """vqa(image, question) → decoded answer string ('Yes'/'No' for DPG)."""

    def vqa(image, question: str) -> str:
        return _run(vision, text, tokenizer, image,
                    VQA_WRAPPER.format(question=question), max_new_tokens,
                    min_pixels, max_pixels)

    return vqa


def make_unified_reward_judge(vision: qwen_vl.QwenVLVision,
                              text: qwen_vl.QwenVLText, tokenizer, *,
                              max_new_tokens: int = 1024,
                              min_pixels: int = 56 * 56,
                              max_pixels: int = 14 * 14 * 4 * 1280):
    """unified_reward(frames, prompt) → raw judge text (one frame per call,
    matching `run_scene_eval`); parse with `gen_eval.parse_unified_scores`."""

    def judge(frames, prompt: str) -> str:
        return _run(vision, text, tokenizer, frames[0],
                    UNIFIED_REWARD_PROMPT.format(prompt=prompt),
                    max_new_tokens, min_pixels, max_pixels)

    return judge
