"""Text → 3D Gaussian splats: prompt → latent → Gaussians → files.

Port of `vist3a_tpu/pipelines/t23d.py`.  `text_to_3dgs` runs the four
stages of one request on one device:
  1. `embed_prompts`: the orbit template around the prompt and the fixed
     negative prompt, each tokenised by the caller's `tokenize` and encoded
     by UMT5;
  2. `denoise`: UniPC over the Wan DiT with classifier-free guidance, the
     pair batched to B = 2, the DiT in its weights' dtype (bf16 deployed)
     and the sampler state in fp32; the noise is `latents0` or a draw from
     a generator on the device seeded with `cfg.seed` (which differs from
     the JAX package's `jax.random` draw);
  3. `decode_and_reconstruct`: the normalised Wan latent is un-normalised,
     decoded by the Wan VAE in bf16, the video cast to fp32 and resized to
     448² as the feed-forward image, and the stitched decoder turns the
     un-normalised latent and that image into Gaussians and context
     cameras;
  4. `export_artifacts`: the orbit video (`gs.mp4`, `depth.mp4`) and
     `gaussians.ply`.
Each stage runs under `torch.profiler` ranges: `t23d.embed`, `t23d.denoise`,
`decode.*` and `export.*`.  Tokenisation is a callable passed in, as in the
JAX package: the HF tokenizer comes with the imported weights.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from vist3a_tpu_torch.diffusion import unipc
from vist3a_tpu_torch.io.ply_export import export_ply
from vist3a_tpu_torch.io.video_export import save_interpolated_video
from vist3a_tpu_torch.nn import umt5 as umt5_mod
from vist3a_tpu_torch.nn import wan_dit, wan_vae
from vist3a_tpu_torch.nn.encoder import EncoderConfig
from vist3a_tpu_torch.stitch import chopped_anysplat as ca

# `inference_t23d.py:88` of the reference, as the JAX package has it
ORBIT_PROMPT_TEMPLATE = (
    "The camera rotates around the scene, maintaining constant distance: "
    "`{prompt}`. The orbiting trajectory captures 3D structure and "
    "consistency."
)
# `inference_t23d.py:90-92`
NEGATIVE_PROMPT = (
    "Background blur, Blurred background, Blurred scene, Artifacts, not "
    "aesthetic, not realistic, rendered noise, low quality movement, low "
    "quality video, low quality image, deformed, disfigured, distorted, "
    "extra limbs, cloned face, skinny, glitchy, double torso, extra arms, "
    "extra hands, mangled fingers, missing lips, ugly face, distorted legs, "
    "fused fingers, too many fingers, long neck"
)


@dataclasses.dataclass(frozen=True)
class T23DConfig:
    width: int = 512
    height: int = 512
    num_frames: int = 13
    num_inference_steps: int = 50
    guidance_scale: float = 5.0
    flow_shift: float = 3.0
    seed: int = 12413                       # `inference_t23d.py:63`
    dit: wan_dit.WanDiTConfig = wan_dit.WAN_1_3B
    umt5: umt5_mod.UMT5Config = umt5_mod.UMT5_XXL
    vae: wan_vae.WanVAEConfig = wan_vae.WanVAEConfig()
    # bf16 DPT-head activations on the inference decode, as deployed
    stitched: ca.StitchedConfig = ca.StitchedConfig(
        encoder=EncoderConfig(head_dtype="bfloat16"))
    feedforward_size: int = 448

    @property
    def latent_shape(self) -> tuple:
        t_lat = (self.num_frames - 1) // 4 + 1
        return (1, 16, t_lat, self.height // 8, self.width // 8)


def embed_prompts(umt5: umt5_mod.UMT5Encoder, tokenize: Callable,
                  prompt: str, *, device: torch.device | str = "cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokenize(text) → (ids (1, L), mask (1, L)), padded to the model's
    `max_sequence_length`.  Returns the (cond, uncond) embeddings
    (1, L, d_model) on `device`, in UMT5's dtype: the orbit template around
    the prompt, and the negative prompt."""
    with record_function("t23d.embed"):
        out = []
        for text in (ORBIT_PROMPT_TEMPLATE.format(prompt=prompt),
                     NEGATIVE_PROMPT):
            ids, mask = (torch.as_tensor(np.asarray(a), device=device)
                         for a in tokenize(text))
            out.append(umt5_mod.encode(umt5, ids, mask))
    return out[0], out[1]


@torch.inference_mode()
def denoise(dit: wan_dit.WanDiT, cond: torch.Tensor, uncond: torch.Tensor,
            cfg: T23DConfig, *, latents0: torch.Tensor | None = None,
            device: torch.device | str = "cuda") -> torch.Tensor:
    """UniPC denoise with CFG → normalised latents (1, 16, T', h, w) fp32.

    The DiT computes in its weights' dtype: the latents and the text are
    cast to it at the model boundary and the velocity back to fp32, so the
    sampler state stays fp32 (`unipc.sample_scan`)."""
    with record_function("t23d.denoise"):
        if latents0 is None:
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
            latents0 = torch.randn(cfg.latent_shape, generator=gen,
                                   device=device)
        dt = dit.patch_embedding.weight.dtype

        def dit_apply(x, ts, text):
            return wan_dit.forward(dit, x.to(dt), ts, text.to(dt)).float()

        model_fn = unipc.cfg_model(dit_apply, cond.to(device),
                                   uncond.to(device), cfg.guidance_scale)
        ucfg = unipc.UniPCConfig(num_steps=cfg.num_inference_steps,
                                 shift=cfg.flow_shift)
        return unipc.sample_scan(model_fn,
                                 latents0.to(device, torch.float32), ucfg)


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


class T23DResult(NamedTuple):
    latents: torch.Tensor     # normalised (1, 16, T', h, w) fp32
    output: object            # the stitched decoder's EncoderOutput
    artifacts: Artifacts


def text_to_3dgs(modules: dict, tokenize: Callable, prompt: str,
                 save_path: str, cfg: T23DConfig = T23DConfig(), *,
                 latents0: torch.Tensor | None = None, orbit_t: int = 10,
                 device: torch.device | str = "cuda") -> T23DResult:
    """One whole request.  modules: {"umt5": UMT5Encoder, "dit": WanDiT,
    "vae": WanVAEDecoder, "stitched": StitchedDecoder}, all on `device`.
    Writes gs.mp4, depth.mp4 and gaussians.ply under `save_path`."""
    cond, uncond = embed_prompts(modules["umt5"], tokenize, prompt,
                                 device=device)
    latents = denoise(modules["dit"], cond, uncond, cfg, latents0=latents0,
                      device=device)
    out, _ = decode_and_reconstruct(modules["vae"], modules["stitched"],
                                    latents, cfg, device=device)
    size = (cfg.feedforward_size, cfg.feedforward_size)
    arts = export_artifacts(out.gaussians, out.extrinsic_c2w,
                            out.intrinsic_norm, save_path, size,
                            orbit_t=orbit_t, device=device)
    return T23DResult(latents, out, arts)
