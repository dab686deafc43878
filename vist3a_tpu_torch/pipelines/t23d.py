"""Text → 3D Gaussian splats, decode half: latent → Gaussians → files.

Port of the decode half of `vist3a_tpu/pipelines/t23d.py`
(`decode_and_reconstruct` and `export_artifacts`): the normalised Wan
latent is un-normalised, decoded by the Wan VAE in bf16, the video cast to
fp32 and resized to 448² as the feed-forward image, and the stitched
decoder turns the un-normalised latent and that image into Gaussians and
context cameras; the export renders the orbit video (`gs.mp4`, `depth.mp4`)
and writes `gaussians.ply`.

Prompt embedding, the denoise and `text_to_3dgs` wait for the denoise
slice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from vist3a_tpu_torch.io.ply_export import export_ply
from vist3a_tpu_torch.io.video_export import save_interpolated_video
from vist3a_tpu_torch.nn import wan_vae
from vist3a_tpu_torch.nn.encoder import EncoderConfig
from vist3a_tpu_torch.stitch import chopped_anysplat as ca


@dataclasses.dataclass(frozen=True)
class T23DConfig:
    width: int = 512
    height: int = 512
    num_frames: int = 13
    vae: wan_vae.WanVAEConfig = wan_vae.WanVAEConfig()
    # bf16 DPT-head activations on the inference decode, as deployed
    stitched: ca.StitchedConfig = ca.StitchedConfig(
        encoder=EncoderConfig(head_dtype="bfloat16"))
    feedforward_size: int = 448

    @property
    def latent_shape(self) -> tuple:
        t_lat = (self.num_frames - 1) // 4 + 1
        return (1, 16, t_lat, self.height // 8, self.width // 8)


def resize_trilinear_half_pixel(video: torch.Tensor,
                                size_hw: tuple[int, int]) -> torch.Tensor:
    """(B, C, T, H, W) → (B, C, T, *size_hw), half-pixel linear in H and W,
    T unchanged.  Antialiased when it shrinks, as `jax.image.resize(...,
    "linear")` is in the JAX package (which therefore differs from the
    reference's plain trilinear `F.interpolate`; ROADMAP Queue 3)."""
    b, c, t, h, w = video.shape
    out = F.interpolate(video.reshape(b, c * t, h, w), size=size_hw,
                        mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(b, c, t, *size_hw)


@torch.inference_mode()
def decode_and_reconstruct(vae: wan_vae.WanVAEDecoder,
                           stitched: ca.StitchedDecoder,
                           latents_norm: torch.Tensor, cfg: T23DConfig, *,
                           device: torch.device | str = "cuda"):
    """Normalised latent (B, 16, T', h, w) → (EncoderOutput, video in
    [−1, 1] (B, 3, T, 8h, 8w) fp32), computed on `device`.

    The VAE decodes in bf16; the stitched decoder takes the un-normalised
    fp32 latent and the fp32 feed-forward image.  Each stage is a
    `torch.profiler` range named `decode.*`."""
    with record_function("decode.vae"):
        latents = wan_vae.unnormalize_latents(
            latents_norm.to(device, torch.float32))
        video = wan_vae.decode(vae, latents.to(torch.bfloat16)).float()
    with record_function("decode.resize"):
        feedforward = resize_trilinear_half_pixel(
            video, (cfg.feedforward_size, cfg.feedforward_size))
    with record_function("decode.stitched"):
        out = ca.forward_with_latent(stitched, latents, feedforward,
                                     cfg.stitched, device=device)
    return out, video


class Artifacts(NamedTuple):
    gs_path: str
    depth_path: str
    ply_path: str
    color: np.ndarray         # (N, 3, H, W) rendered orbit frames in [0, 1]
    depth: np.ndarray         # (N, H, W) rendered depth


def export_artifacts(gaussians, extrinsic_c2w, intrinsic_norm,
                     save_path: str, image_shape=(448, 448), *,
                     orbit_t: int = 10,
                     device: torch.device | str = "cuda") -> Artifacts:
    """Orbit video (gs.mp4 + depth.mp4) and gaussians.ply of batch entry 0,
    rendered on `device`."""
    g = gaussians
    video = save_interpolated_video(
        extrinsic_c2w, intrinsic_norm, g, image_shape, save_path, t=orbit_t,
        device=device)
    with record_function("export.ply"):
        ply_path = export_ply(
            g.means[0], g.scales[0], g.rotations[0], g.harmonics[0],
            g.opacities[0], os.path.join(save_path, "gaussians.ply"))
    return Artifacts(video.gs_path, video.depth_path, str(ply_path),
                     video.color, video.depth)
