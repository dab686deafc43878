"""Reward-aligned VDM fine-tuning: the loop.

Port of `vist3a_tpu/cli/train_vdm.py::run` for one device: per step one
text batch (its first prompt, camera-augmented, is the rollout prompt) and
one video batch (the SFT clip and its captions), the prompts embedded by
`embed_text`, the scorer text features of the prompt from
`reward_text_fn`, then `vdm_train_step`.  The loaders are any iterables:
`text_loader` yields {"prompt": [str]}, `video_loader` {"image_tensor":
(B, 3, T, H, W) in [−1, 1], "caption": [str]}; the video loader restarts
when it runs out, and the text loader is walked until `num_steps`.

With `save_path` the loop saves a `checkpoint-N` folder every `save_freq`
steps (`io/checkpoints.py`, `train_vdm.py:439-496`); `resume_path` (such a
folder, or a folder holding them: the latest is taken) restores the step,
the LoRA factors, the AdamW state, the EMA shadow and the position of the
host-side draws (the prompt augmentation's generator), and both loaders
skip the batches the saved run consumed (`train_vdm.py:465-496`), so the
run goes on exactly as an unbroken one.  Resuming mid-stream needs sized
loaders.

Not here yet (ROADMAP Queue 1, items 14-15): the CLIP text towers and
tokenizers behind `reward_text_fn` (`build_reward_fns`), the prompt and
video data loaders, the every-10-step image grid and the metric stream
(`main`).
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from vist3a_tpu_torch.io import checkpoints as ckpt
from vist3a_tpu_torch.nn import wan_dit, wan_vae
from vist3a_tpu_torch.stitch import chopped_anysplat as ca
from vist3a_tpu_torch.train import ema as ema_mod
from vist3a_tpu_torch.train import vdm


def save(save_path, state: vdm.VDMTrainState,
         rng: np.random.Generator) -> str:
    """`checkpoint-{state.step}` of the run's state and draws' position."""
    lora = vdm.flat_lora(state.lora)
    return ckpt.save_vdm_checkpoint(
        save_path, state.step, lora=lora,
        lora_ema=ema_mod.ema_params_like(state.ema, lora),
        opt_state=state.optimizer.state_dict(), ema_shadow=state.ema,
        meta={"step": state.step, "rng": rng.bit_generator.state})


def restore(resume_path, state: vdm.VDMTrainState,
            rng: np.random.Generator) -> str:
    """Load a `checkpoint-N` folder (or the latest one inside
    `resume_path`) into `state` and `rng`, in place; returns its path."""
    path = resume_path
    if not (Path(path) / "meta.json").exists():
        path = ckpt.latest_checkpoint(resume_path)
        if path is None:
            raise FileNotFoundError(f"no checkpoint-N under {resume_path}")
    lora, _, opt_state, ema_shadow, meta = ckpt.load_vdm_checkpoint(path)
    own = vdm.flat_lora(state.lora)
    if own.keys() != lora.keys() or state.ema.keys() != ema_shadow.keys():
        raise KeyError(f"{path} holds other LoRA sites than the run's")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(lora[k])
            state.ema[k].copy_(ema_shadow[k])
    state.optimizer.load_state_dict(opt_state)
    state.step = int(meta["step"])
    rng.bit_generator.state = meta["rng"]
    return str(path)


def _position(loader, step: int) -> int:
    """Batches of `loader`'s current pass that `step` steps consumed."""
    if not step:
        return 0
    try:
        return step % len(loader)
    except TypeError:
        raise ValueError("resuming mid-stream needs loaders with a length "
                         "(the batches consumed cannot be skipped)") from None


def run(state: vdm.VDMTrainState, dit: wan_dit.WanDiT,
        vae_encoder: wan_vae.WanVAEEncoder,
        vae_decoder: wan_vae.WanVAEDecoder, stitched: ca.StitchedDecoder, *,
        text_loader, video_loader, embed_text: Callable,
        reward_loss_fn: Callable | None, scfg: ca.StitchedConfig,
        cfg: vdm.VDMTrainConfig, num_steps: int, save_path=None,
        save_freq: int = 100, resume_path=None, seed: int = 23,
        latent_shape=(1, 16, 4, 64, 64), render_size: int = 448,
        on_metrics=None, uncond_embeds: torch.Tensor | None = None,
        reward_text_fn: Callable | None = None):
    """The VDM loop until `state.step == num_steps`.  embed_text(list[str])
    → (B, L, text_dim) on the models' device; reward_text_fn(prompt) →
    (pick_text, pe_text).  Returns (state, history), history the metrics
    of every step of this call (floats, the draws, the prompt)."""
    device = dit.patch_embedding.weight.device
    rng = np.random.default_rng(seed)
    if resume_path is not None:
        restore(resume_path, state, rng)
    history = []
    skip_text = _position(text_loader, state.step)
    video_iter = itertools.islice(iter(video_loader),
                                  _position(video_loader, state.step), None)
    while state.step < num_steps:
        texts = itertools.islice(iter(text_loader), skip_text, None)
        skip_text = 0
        for text_batch in texts:
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
            if save_path is not None and state.step % save_freq == 0:
                save(save_path, state, rng)
    return state, history
