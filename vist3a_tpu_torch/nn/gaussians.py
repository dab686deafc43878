"""3D Gaussians and the unified Gaussian adapter.

Port of `vist3a_tpu/nn/gaussians.py`: scales = min(0.001·softplus, 0.3),
unit xyzw quaternions, SH coefficients masked per degree (0.1·0.25^deg),
covariance R·diag(s)²·Rᵀ, and `map_pdf_to_opacity` (the identity at the
deployed initial = final = 0).  Every masked pixel stays in the output with
opacity 0, so the Gaussian count is S·H·W.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vist3a_tpu_torch.nn.geometry import quat_to_mat


class Gaussians(NamedTuple):
    means: torch.Tensor        # (B, G, 3)
    covariances: torch.Tensor  # (B, G, 3, 3)
    harmonics: torch.Tensor    # (B, G, 3, d_sh)
    opacities: torch.Tensor    # (B, G)
    scales: torch.Tensor       # (B, G, 3)
    rotations: torch.Tensor    # (B, G, 4) xyzw


def sh_mask(sh_degree: int, device=None) -> torch.Tensor:
    mask = torch.ones((sh_degree + 1) ** 2, device=device)
    for degree in range(1, sh_degree + 1):
        mask[degree ** 2:(degree + 1) ** 2] = 0.1 * 0.25 ** degree
    return mask


def covariance_entries(scale: torch.Tensor,
                       rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """R diag(s)² Rᵀ as (..., 9) row-major entries (quaternion eps 1e-8)."""
    r = quat_to_mat(rotation_xyzw, eps=1e-8)
    m = r * scale[..., None, :]                 # M = R diag(s)
    # Σ[a, b] = Σ_j M[a, j]·M[b, j], elementwise (no TF32 matmul on a card)
    return (m.unsqueeze(-2) * m.unsqueeze(-3)).sum(-1).flatten(-2)


def build_covariance(scale: torch.Tensor,
                     rotation_xyzw: torch.Tensor) -> torch.Tensor:
    return covariance_entries(scale, rotation_xyzw).unflatten(-1, (3, 3))


def map_pdf_to_opacity(pdf: torch.Tensor, global_step: int = 0,
                       initial: float = 0.0, final: float = 0.0,
                       warm_up: int = 1) -> torch.Tensor:
    x = initial + min(global_step / warm_up, 1.0) * (final - initial)
    exponent = 2.0 ** x
    return 0.5 * (1 - (1 - pdf) ** exponent + pdf ** (1 / exponent))


def unified_gaussian_adapter(means: torch.Tensor, opacities: torch.Tensor,
                             raw_gaussians: torch.Tensor, sh_degree: int = 4,
                             eps: float = 1e-8) -> Gaussians:
    """raw (..., 7 + 3·d_sh) → calibrated Gaussians, all fp32."""
    d_sh = (sh_degree + 1) ** 2
    raw = raw_gaussians.float()
    scales = torch.clamp_max(0.001 * F.softplus(raw[..., :3]), 0.3)
    rotations = raw[..., 3:7]
    rotations = rotations / (
        torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps)
    sh = raw[..., 7:7 + 3 * d_sh].unflatten(-1, (3, d_sh)) \
        * sh_mask(sh_degree, raw.device)
    return Gaussians(means=means.float(),
                     covariances=build_covariance(scales, rotations),
                     harmonics=sh, opacities=opacities.float(),
                     scales=scales, rotations=rotations)
