"""Flow-matching SFT loss pieces.

Port of `vist3a_tpu/diffusion/flow_match.py` (the reference's
`train_vdm.py:541-563`): z₀ is the normalised VAE latent, σ ~ U(0, 1) per
sample, z_σ = (1 − σ)·z₀ + σ·ε, the target velocity v = ε − z₀, the loss
an fp32 MSE, the timestep 1000·σ.  The draws come from an explicit
generator (JAX folds keys; the numbers differ, so the tests pass ε and σ
in).
"""

from __future__ import annotations

import torch


def make_flow_batch(z0: torch.Tensor, generator: torch.Generator | None = None,
                    *, eps: torch.Tensor | None = None,
                    sigma: torch.Tensor | None = None):
    """z0 (B, C, T, H, W) normalised latent → (z_sigma, timestep, target),
    fp32.  ε ~ N(0, 1) and σ ~ U(0, 1) are drawn from `generator` (on z0's
    device) unless given."""
    z0f = z0.float()
    if eps is None:
        eps = torch.randn(z0.shape, generator=generator, device=z0.device)
    if sigma is None:
        sigma = torch.rand(z0.shape[0], generator=generator,
                           device=z0.device)
    s = sigma.float().reshape(-1, 1, 1, 1, 1)
    z_sigma = (1.0 - s) * z0f + s * eps.float()
    return z_sigma, sigma.float() * 1000.0, eps.float() - z0f


def flow_matching_loss(pred: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))
