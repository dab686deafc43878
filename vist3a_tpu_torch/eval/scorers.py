"""Scorer adapters of the generation-evaluation harness.

Port of `vist3a_tpu/eval/scorers.py` (the reference's
`evaluation/gen_eval/gen_metrics/`):

  * `make_clip_scorer` — CLIPScore averaged over the sampled frames, the
    torchmetrics convention 100·max(cos(image, text), 0)
    (`clip_score.py:17-27`); LongCLIP (248-token text) is the same adapter
    over another text tower;
  * `make_aesthetic_scorer` — the LAION aesthetic probe: L2-normalised CLIP
    ViT-L/14 image features through a 768→1 linear head, mean/10 over the
    frames (`aesthetic_quality.py:55-114`);
  * `make_clip_text_features` — prompt → normalised text features through
    the port's CLIP tokenizer (`data/clip_tokenizer.py`) and text tower
    (`nn/clip.py`, `CLIP_L_TEXT` / `LONGCLIP_L_TEXT`).

The towers run in their own dtype (fp32) on their own device.  Frames
become CLIP input as the JAX package makes it: a bicubic resize of the
shorter side with `jax.image.resize`'s antialiasing
(`ops/resize.py`, on the towers' device), a centre crop, then the CLIP
mean / std in float64 and a cast to fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from vist3a_tpu_torch.nn import clip as clip_mod
from vist3a_tpu_torch.ops.resize import resize

CLIP_L_224 = clip_mod.CLIPVisionConfig(
    hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
    patch_size=14, image_size=224, projection_dim=768, act="quick_gelu")


def _frames_to_clip_input(frames, size: int,
                          device: torch.device | str = "cpu") -> torch.Tensor:
    """list of (H, W, 3) uint8 → CLIP-normalised (N, 3, size, size) fp32 on
    `device`: bicubic shorter-side resize + centre crop (openai
    clip_transform)."""
    out = []
    mean = np.asarray(clip_mod.CLIP_MEAN).reshape(3, 1, 1)
    std = np.asarray(clip_mod.CLIP_STD).reshape(3, 1, 1)
    for f in frames:
        img = torch.from_numpy(np.asarray(f, np.float32)).to(device)
        img = img.permute(2, 0, 1)[None] / 255.0
        _, c, h, w = img.shape
        if h < w:
            nh, nw = size, max(round(w * size / h), size)
        else:
            nw, nh = size, max(round(h * size / w), size)
        img = resize(img, (1, c, nh, nw), "bicubic", antialias=True)
        y0, x0 = (nh - size) // 2, (nw - size) // 2
        img = img[0, :, y0:y0 + size, x0:x0 + size].double().cpu().numpy()
        out.append((img - mean) / std)
    return torch.from_numpy(np.stack(out).astype(np.float32)).to(device)


def make_clip_text_features(text_model: clip_mod.CLIPText, tokenizer, *,
                            pad: str = "eos"):
    """prompt → normalised (D,) text features on the tower's device.

    tokenizer: `data.clip_tokenizer.CLIPTokenizer` (pad='eos' matches the
    HF processors of torchmetrics' CLIPScore; 'zero' matches open_clip).
    The tower's config gives the context length (248 for LongCLIP-L)."""
    n = text_model.cfg.context_length

    def text_features_fn(prompt: str) -> torch.Tensor:
        ids = torch.from_numpy(tokenizer([prompt], n, pad=pad))
        with torch.no_grad():
            return clip_mod.text_features(text_model, ids)[0]

    return text_features_fn


def make_clip_scorer(vision: clip_mod.CLIPVision, text_features_fn):
    """CLIPScore(frames, prompt) = mean over frames of
    100·max(cos(image, text), 0); text_features_fn(prompt) → (D,)."""
    device = vision.patch.device

    def score(frames, prompt) -> float:
        px = _frames_to_clip_input(frames, vision.cfg.image_size, device)
        with torch.no_grad():
            img = clip_mod.image_features(vision, px)
        txt = torch.as_tensor(text_features_fn(prompt)).to(img).reshape(-1)
        txt = txt / torch.linalg.vector_norm(txt)
        cos = img @ txt
        return float(torch.mean(100.0 * torch.clamp(cos, min=0.0)))

    return score


def make_aesthetic_scorer(vision: clip_mod.CLIPVision, linear_w, linear_b):
    """LAION aesthetic probe: normalised ViT-L/14 features → 768→1 linear;
    mean(score)/10 over frames (`aesthetic_quality.py:86-114`)."""
    device = vision.patch.device
    w = torch.as_tensor(np.asarray(linear_w, np.float32).reshape(-1),
                        device=device)
    b = float(np.asarray(linear_b, np.float32).reshape(()))

    def score(frames) -> float:
        px = _frames_to_clip_input(frames, vision.cfg.image_size, device)
        with torch.no_grad():
            feats = clip_mod.image_features(vision, px)
        s = feats @ w + b
        return float(torch.mean(s) / 10.0)

    return score
