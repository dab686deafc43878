"""Exponential moving average over the trainable tensors.

Port of `vist3a_tpu/train/ema.py` (the reference's `utils/ema.py`,
`FSDPEMAWrapper`): an fp32 shadow of the trainables, the warm-up decay
`min((1 + step)/(10 + step), decay)` (:47-48), the update
`ema ← d·ema + (1 − d)·p` every `update_step_interval` steps.  The shadow
is a dict of tensors keyed like the trainables; `update_ema` updates it in
place (the JAX package returns a new tree), under no grad.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    decay: float = 0.99
    update_step_interval: int = 1


def init_ema(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """fp32 copies of `params` (name → tensor)."""
    return {k: p.detach().float().clone() for k, p in params.items()}


def current_decay(step: int, decay: float = 0.99) -> float:
    """Warm-up decay `min((1 + s)/(10 + s), decay)`, in fp32 as the JAX
    package computes it."""
    s = torch.tensor(float(step), dtype=torch.float32)
    return float(torch.minimum((1.0 + s) / (10.0 + s),
                               torch.tensor(decay, dtype=torch.float32)))


@torch.no_grad()
def update_ema(ema: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               step: int, cfg: EMAConfig = EMAConfig()) -> None:
    """One EMA step in place; `step` is the 0-based optimizer step (the
    reference updates when `(step + 1) % interval == 0`)."""
    if (step + 1) % cfg.update_step_interval:
        return
    d = current_decay(step, cfg.decay)
    for k, e in ema.items():
        e.mul_(d).add_(params[k].detach().float(), alpha=1.0 - d)


def ema_params_like(ema: dict[str, torch.Tensor],
                    params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The shadow cast back to the params' dtypes (the reference's
    `copy_ema_to`, for saving and evaluation)."""
    return {k: e.to(params[k].dtype) for k, e in ema.items()}
