"""Reward-aligned VDM fine-tuning: the loop.

Port of `vist3a_tpu/cli/train_vdm.py::run` for one device: per step one
text batch (its first prompt, camera-augmented, is the rollout prompt) and
one video batch (the SFT clip and its captions), the prompts embedded by
`embed_text`, the scorer text features of the prompt from
`reward_text_fn`, then `vdm_train_step`.  The loaders are any iterables:
`text_loader` yields {"prompt": [str]}, `video_loader` {"image_tensor":
(B, 3, T, H, W) in [−1, 1], "caption": [str]}; the video loader restarts
when it runs out, and the text loader is walked until `num_steps`.

Not here yet (slice 6, once the weights and data are in the repository):
the CLIP text towers and tokenizers behind `reward_text_fn`
(`build_reward_fns`), the prompt and video data loaders with their resume
position, checkpoint save and resume, the every-10-step image grid and the
metric stream (`main`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vist3a_tpu_torch.nn import wan_dit, wan_vae
from vist3a_tpu_torch.stitch import chopped_anysplat as ca
from vist3a_tpu_torch.train import vdm


def run(state: vdm.VDMTrainState, dit: wan_dit.WanDiT,
        vae_encoder: wan_vae.WanVAEEncoder,
        vae_decoder: wan_vae.WanVAEDecoder, stitched: ca.StitchedDecoder, *,
        text_loader, video_loader, embed_text: Callable,
        reward_loss_fn: Callable | None, scfg: ca.StitchedConfig,
        cfg: vdm.VDMTrainConfig, num_steps: int, save_path=None,
        seed: int = 23, latent_shape=(1, 16, 4, 64, 64),
        render_size: int = 448, on_metrics=None,
        uncond_embeds: torch.Tensor | None = None,
        reward_text_fn: Callable | None = None):
    """The VDM loop until `state.step == num_steps`.  embed_text(list[str])
    → (B, L, text_dim) on the models' device; reward_text_fn(prompt) →
    (pick_text, pe_text).  Returns (state, history), history the metrics
    of every step (floats, the draws, the prompt)."""
    if save_path is not None:
        raise NotImplementedError(
            "VDM checkpoints (save_path) come with io/checkpoints.py in "
            "slice 6")
    device = dit.patch_embedding.weight.device
    rng = np.random.default_rng(seed)
    history = []
    video_iter = iter(video_loader)
    while state.step < num_steps:
        for text_batch in text_loader:
            if state.step >= num_steps:
                break
            try:
                video_batch = next(video_iter)
            except StopIteration:
                video_iter = iter(video_loader)
                video_batch = next(video_iter)
            prompt = text_batch["prompt"][0]
            sft_text = embed_text(list(video_batch["caption"]))
            rl_prompt = vdm.augment_camera_prompt(rng, prompt) \
                if cfg.enable_rl else prompt
            rl_cond = embed_text([rl_prompt])
            rl_uncond = (uncond_embeds.to(device) if uncond_embeds is not None
                         else torch.zeros_like(rl_cond))
            reward_text = (reward_text_fn(prompt)
                           if cfg.enable_rl and reward_text_fn else None)
            metrics = vdm.vdm_train_step(
                state, dit, vae_encoder, vae_decoder, stitched,
                video=video_batch["image_tensor"].to(device),
                sft_text=sft_text, rl_cond=rl_cond, rl_uncond=rl_uncond,
                reward_loss_fn=reward_loss_fn, seed=seed, scfg=scfg, cfg=cfg,
                latent_shape=latent_shape, render_size=render_size,
                reward_text=reward_text)
            history.append({
                "step": state.step, "prompt": prompt,
                "rl_prompt": rl_prompt,
                **{k: v if isinstance(v, (bool, int, float, list))
                   else float(v) for k, v in metrics.items()}})
            if on_metrics:
                on_metrics(history[-1])
    return state, history
