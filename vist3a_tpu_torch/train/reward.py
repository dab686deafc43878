"""Reward models: the PickScore + DFN5B-CLIP mixed loss on rendered views.

Port of `vist3a_tpu/train/reward.py` (the reference's `utils/reward.py`):
  * `pickscore_preprocess` (:62-88): [−1, 1] → [0, 1], a bicubic antialiased
    resize to shorter side 224 (aspect kept), a centre crop, CLIP
    normalisation;
  * `peclip_preprocess` (:107-111): a bilinear antialiased resize to 378²,
    CLIP normalisation;
  * `make_loss_fn` (:117-193): pick loss |target − logit_scale·⟨t, i⟩/100|,
    PE loss 1 − ⟨t, i⟩, mixed 0.25 / 0.25; the text features are inputs
    (computed off the path, without grad, by the text towers of slice 6);
  * `calculate_reward` (:198-256): the stitched decoder on the rollout's
    latents and its decoded video (the feed-forward resize to 448² is
    trilinear align_corners=True, not the antialiased resize of `t23d`),
    13 randomly permuted predicted views rendered at 448² with a 1×G pair
    budget (G = latent_t·448²) and recomputed per view, scored with one
    random decoded frame.

The resizes go to `F.interpolate(..., antialias=True)`, whose bicubic
kernel on the antialias path is Keys' a = −0.5, as `jax.image.resize`'s
(the tests hold both against the JAX package).  Draws come from explicit
generators (JAX folds keys), or are passed in (`perm`, `frame`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from vist3a_tpu_torch.nn import clip as clip_mod
from vist3a_tpu_torch.nn.splat_decoder import render
from vist3a_tpu_torch.stitch import chopped_anysplat as ca


def _normalize(im: torch.Tensor) -> torch.Tensor:
    mean = im.new_tensor(clip_mod.CLIP_MEAN).reshape(1, 3, 1, 1)
    std = im.new_tensor(clip_mod.CLIP_STD).reshape(1, 3, 1, 1)
    return (im - mean) / std


def pickscore_preprocess(im_pm1: torch.Tensor, size: int = 224
                         ) -> torch.Tensor:
    """(B, 3, H, W) in [−1, 1] → CLIP-normalised size²."""
    im = torch.clamp(im_pm1 / 2.0 + 0.5, 0.0, 1.0)
    _, _, h, w = im.shape
    if h < w:
        height, width = size, w * size // h
    else:
        width, height = size, h * size // w
    im = F.interpolate(im, size=(height, width), mode="bicubic",
                       align_corners=False, antialias=True)
    startx = width // 2 - size // 2
    starty = height // 2 - size // 2
    return _normalize(im[:, :, starty:starty + size, startx:startx + size])


def peclip_preprocess(im_pm1: torch.Tensor, size: int = 378) -> torch.Tensor:
    im = torch.clamp(im_pm1 / 2.0 + 0.5, 0.0, 1.0)
    im = F.interpolate(im, size=(size, size), mode="bilinear",
                       align_corners=False, antialias=True)
    return _normalize(im)


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    pickscore_weight: float = 0.25
    peclip_weight: float = 0.25
    pickscore_target: float = 1.0
    pickscore_div: float = 100.0
    pick_cfg: clip_mod.CLIPVisionConfig = clip_mod.CLIP_H_224
    pe_cfg: clip_mod.CLIPVisionConfig = clip_mod.DFN5B_H_378


def make_loss_fn(pick: clip_mod.CLIPVision, pe: clip_mod.CLIPVision, *,
                 pick_text: torch.Tensor | None = None,
                 pe_text: torch.Tensor | None = None, logit_scale: float,
                 cfg: RewardConfig = RewardConfig()) -> Callable:
    """pick_text / pe_text: L2-normalised text features (B_txt, D), bound
    here or passed per call.  Returns loss_fn(im_pm1, pick_text=None,
    pe_text=None) → (loss, mixed_score, scores)."""
    bound_pick, bound_pe = pick_text, pe_text

    def loss_fn(im_pm1, pick_text=None, pe_text=None):
        pick_text = bound_pick if pick_text is None else pick_text
        pe_text = bound_pe if pe_text is None else pe_text
        if pick_text is None or pe_text is None:
            raise ValueError(
                "reward loss needs text features: bind pick_text/pe_text in "
                "make_loss_fn or pass them per call")
        b = im_pm1.shape[0]
        pick_img = clip_mod.image_features(
            pick, pickscore_preprocess(im_pm1, cfg.pick_cfg.image_size))
        pt = pick_text.expand(b, -1) if pick_text.shape[0] == 1 else pick_text
        pick_diag = logit_scale * torch.sum(pt * pick_img, dim=-1)
        pick_scaled = pick_diag / cfg.pickscore_div
        pick_loss = torch.mean(torch.abs(cfg.pickscore_target - pick_scaled))

        pe_img = clip_mod.image_features(
            pe, peclip_preprocess(im_pm1, cfg.pe_cfg.image_size))
        et = pe_text.expand(b, -1) if pe_text.shape[0] == 1 else pe_text
        pe_diag = torch.sum(et * pe_img, dim=-1)
        pe_loss = torch.mean(1.0 - pe_diag)

        loss = cfg.pickscore_weight * pick_loss + cfg.peclip_weight * pe_loss
        mixed = (cfg.pickscore_weight * torch.mean(pick_scaled)
                 + cfg.peclip_weight * torch.mean(pe_diag))
        scores = {"pickscore_raw": torch.mean(pick_diag),
                  "pickscore_scaled": torch.mean(pick_scaled),
                  "peclip_score": torch.mean(pe_diag)}
        return loss, mixed, scores

    return loss_fn


def calculate_reward(gen_latents: torch.Tensor, video: torch.Tensor,
                     stitched: ca.StitchedDecoder, scfg: ca.StitchedConfig,
                     loss_fn: Callable, *,
                     generator: torch.Generator | None = None,
                     perm: torch.Tensor | None = None,
                     frame: int | None = None, num_render_views: int = 13,
                     render_size: int = 448, pair_budget: int | None = None,
                     text_feats=None):
    """For batch size 1 (the reference's loop body).  gen_latents (1, 16,
    T, h, w) un-normalised; video (1, 3, T_pix, H, W) decoded frames in
    [−1, 1].  The view permutation and the decoded frame are drawn from
    `generator` unless given.  text_feats: optional (pick_text, pe_text)
    passed to loss_fn.  Returns (reward_loss, (decoded_frame (1, H, W, 3),
    rendered_views (V, H, W, 3)) in [0, 1])."""
    tkw = ({} if text_feats is None
           else {"pick_text": text_feats[0], "pe_text": text_feats[1]})
    if pair_budget is None:
        # the reward path's 1×G budget (the rasterizer's own default is 4×G)
        pair_budget = scfg.latent_t * render_size * render_size
    device = gen_latents.device
    t_pix = video.shape[2]
    feedforward = ca.resize_align_corners_nd(
        video, {3: render_size, 4: render_size})
    out = ca.forward_with_latent(stitched, gen_latents, feedforward.float(),
                                 scfg, device=device, remat=True)
    n_views = out.extrinsic_c2w.shape[1]
    if perm is None:
        perm = torch.randperm(n_views, generator=generator,
                              device=generator.device if generator else "cpu")
    perm = perm[:num_render_views].to(device)
    rendered = render(out.gaussians, out.extrinsic_c2w[:, perm],
                      out.intrinsic_norm[:, perm], (render_size, render_size),
                      pair_budget=pair_budget, remat_views=True,
                      device=device).color[0]               # (V, 3, H, W)
    loss_r, _, _ = loss_fn(rendered * 2.0 - 1.0, **tkw)
    if frame is None:
        frame = int(torch.randint(t_pix, (), generator=generator,
                                  device=generator.device if generator
                                  else "cpu"))
    decoded = feedforward[:, :, frame]                      # (1, 3, H, W)
    loss_d, _, _ = loss_fn(decoded, **tkw)
    imgs = (((decoded + 1) / 2).permute(0, 2, 3, 1).detach(),
            rendered.permute(0, 2, 3, 1).detach())
    return loss_r + loss_d, imgs
