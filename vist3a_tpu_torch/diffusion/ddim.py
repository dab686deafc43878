"""DDIM with v-prediction (CogVideoX's scheduler).

diffusers `CogVideoXDDIMScheduler` as CogVideoX-5B's
`scheduler/scheduler_config.json` sets it, sampled with eta 0:
  * scaled-linear betas (√0.00085 → √0.012 linearly, squared) over 1000
    training steps, ᾱ their cumulative product, shifted by
    `snr_shift_scale` (ᾱ / (s + (1 − s)·ᾱ), the identity at 1.0) and
    rescaled to zero terminal SNR (√ᾱ shifted and scaled so that
    √ᾱ₉₉₉ = 0 and √ᾱ₀ is kept), so ᾱ₉₉₉ = 0;
  * "trailing" timesteps: round(arange(1000, 0, −1000/N)) − 1, for N = 50
    999, 979, …, 19; each step goes to t − 1000 // N, and ᾱ_prev = 1
    (`set_alpha_to_one`) after the last;
  * each step, from the model's v:
      x₀ = √ᾱ_t·x − √(1 − ᾱ_t)·v,
      x_prev = √((1 − ᾱ_prev)/(1 − ᾱ_t))·x
               + (√ᾱ_prev − √ᾱ_t·√((1 − ᾱ_prev)/(1 − ᾱ_t)))·x₀.

The schedule is computed on the host in float64 (diffusers: float32) and
reaches the latents as fp32 scalars; the state stays fp32.  Each step of
`sample_scan` is a span `ddim.step` (`core/profiling.span`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from vist3a_tpu_torch.core.profiling import span


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_steps: int = 50
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    snr_shift_scale: float = 1.0


def alphas_cumprod(cfg: DDIMConfig) -> np.ndarray:
    """ᾱ over the training steps (float64): scaled-linear betas, the SNR
    shift, the zero-terminal-SNR rescale."""
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.num_train_timesteps, dtype=np.float64) ** 2
    ab = np.cumprod(1.0 - betas)
    ab = ab / (cfg.snr_shift_scale + (1.0 - cfg.snr_shift_scale) * ab)
    root = np.sqrt(ab)
    r0, r_last = root[0], root[-1]
    root = (root - r_last) * (r0 / (r0 - r_last))
    return root ** 2


def timesteps(cfg: DDIMConfig) -> np.ndarray:
    """The trailing spacing, descending (int64)."""
    n, steps = cfg.num_train_timesteps, cfg.num_steps
    return np.round(np.arange(n, 0, -n / steps)).astype(np.int64) - 1


def precompute_coeffs(cfg: DDIMConfig) -> dict[str, np.ndarray]:
    """Every per-step scalar of the chain, float32 arrays of length
    num_steps: x₀ = x0_x·x − x0_v·v, x_prev = prev_x·x + prev_x0·x₀."""
    ab = alphas_cumprod(cfg)
    ts = timesteps(cfg)
    step = cfg.num_train_timesteps // cfg.num_steps
    a_t = ab[ts]
    a_prev = np.array([ab[t - step] if t - step >= 0 else 1.0 for t in ts])
    ratio = np.sqrt((1.0 - a_prev) / (1.0 - a_t))
    return {"timesteps": ts.astype(np.float32),
            "x0_x": np.sqrt(a_t).astype(np.float32),
            "x0_v": np.sqrt(1.0 - a_t).astype(np.float32),
            "prev_x": ratio.astype(np.float32),
            "prev_x0": (np.sqrt(a_prev) - np.sqrt(a_t) * ratio
                        ).astype(np.float32)}


def _step(per: dict, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    x0 = per["x0_x"] * x - per["x0_v"] * v
    return per["prev_x"] * x + per["prev_x0"] * x0


def sample_scan(model_fn: Callable, latents: torch.Tensor,
                cfg: DDIMConfig = DDIMConfig()) -> torch.Tensor:
    """The denoise loop.  model_fn(x, t) → v (CFG folded in by the
    caller), t a 0-d fp32 tensor; returns the final latent.  The fp32
    coefficients are one tensor per name on the latents' device, copied
    there once and read without a host sync."""
    coeffs = {k: torch.from_numpy(v).to(latents.device)
              for k, v in precompute_coeffs(cfg).items()}
    x = latents
    for i in range(cfg.num_steps):
        with span("ddim.step"):
            per = {k: v[i] for k, v in coeffs.items()}
            x = _step(per, model_fn(x, per["timesteps"]), x)
    return x
