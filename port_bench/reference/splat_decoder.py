"""The plain reference's splatting render: Gaussians + cameras → colour,
depth, alpha (frozen from the port's `nn/splat_decoder.py`; see
`reference/scene.py`; it imports nothing of the port).

c2w extrinsics are inverted to w2c view matrices in fp32, width/height-
normalised intrinsics are scaled back to pixels, every view goes through
the rasterizer with near plane 1e-10 and radius clip 0.1 on a black
background, and the colour is clipped to [0, 1].  The batch is a loop
(B = 1 wherever this runs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference.rasterizer import rasterize
from port_bench.reference.gaussians import Gaussians


class DecoderOutput(NamedTuple):
    color: torch.Tensor   # (B, V, 3, H, W) in [0, 1]
    depth: torch.Tensor   # (B, V, H, W)
    alpha: torch.Tensor   # (B, V, H, W)


def render(gaussians: Gaussians, extrinsics_c2w: torch.Tensor,
           intrinsics_norm: torch.Tensor, image_shape: tuple[int, int], *,
           pair_budget: int | None = None,
           device: torch.device | str = "cuda") -> DecoderOutput:
    """extrinsics_c2w (B, V, 4, 4), intrinsics_norm (B, V, 3, 3) with the
    first row divided by W and the second by H; computed on `device`.
    pair_budget goes to `rasterize`."""
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
            pair_budget=pair_budget)
        outs.append((torch.clamp(rgb, 0.0, 1.0).permute(0, 3, 1, 2), dep,
                     alp))
    color, depth, alpha = (torch.stack(x) for x in zip(*outs))
    return DecoderOutput(color, depth, alpha)
