"""Splatting decoder: Gaussians + cameras → rendered colour, depth, alpha.

Port of `vist3a_tpu/nn/splat_decoder.py::render`: c2w extrinsics are
inverted to w2c view matrices in fp32, width/height-normalised intrinsics
are scaled back to pixels, every view goes through the rasterizer with
near plane 1e-10 and radius clip 0.1 on a black background, and the
colour is clipped to [0, 1].
The batch is a loop (B = 1 wherever this runs).  `render` runs in the
caller's grad mode: differentiable in the Gaussians (the reward path), or
under `torch.inference_mode` (the export).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vist3a_tpu_torch.kernels.rasterizer import rasterize
from vist3a_tpu_torch.nn.gaussians import Gaussians


class DecoderOutput(NamedTuple):
    color: torch.Tensor   # (B, V, 3, H, W) in [0, 1]
    depth: torch.Tensor   # (B, V, H, W)
    alpha: torch.Tensor   # (B, V, H, W)


def render(gaussians: Gaussians, extrinsics_c2w: torch.Tensor,
           intrinsics_norm: torch.Tensor, image_shape: tuple[int, int], *,
           pair_budget: int | None = None, remat_views: bool = False,
           device: torch.device | str = "cuda") -> DecoderOutput:
    """extrinsics_c2w (B, V, 4, 4), intrinsics_norm (B, V, 3, 3) with the
    first row divided by W and the second by H; computed on `device`.
    pair_budget and remat_views go to `rasterize`."""
    h, w = image_shape
    device = torch.device(device)
    scale = torch.tensor([[w], [h], [1.0]], device=device)
    outs = []
    for b in range(extrinsics_c2w.shape[0]):
        viewmats = torch.linalg.inv(extrinsics_c2w[b].to(device).float())
        ks = intrinsics_norm[b].to(device).float() * scale
        rgb, dep, alp = rasterize(
            *(x[b].to(device) for x in (
                gaussians.means, gaussians.covariances, gaussians.harmonics,
                gaussians.opacities)), viewmats, ks, w, h,
            pair_budget=pair_budget, remat_views=remat_views)
        outs.append((torch.clamp(rgb, 0.0, 1.0).permute(0, 3, 1, 2), dep,
                     alp))
    color, depth, alpha = (torch.stack(x) for x in zip(*outs))
    return DecoderOutput(color, depth, alpha)
