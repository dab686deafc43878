"""Chopped AnySplat + conv3d stitching layer: the stitched decoder.

Port of `vist3a_tpu/stitch/chopped_anysplat.py`.  `forward_with_latent` takes
an un-normalised Wan latent (B, 16, T_vae, h, w) and feed-forward images
(B, 3, S, H, W) in [−1, 1]:

  1. trilinear align_corners=True pre-upsample of the latent to
     S = (T_vae − 1)·4 + 1 frames (`pre_upsample`);
  2. the conv3d stitch (`conv_spec`) → (B, 1024, S, H/14, W/14) tokens;
  3. the DINOv2 blocks after the chop (cls token, interpolated pos-embed,
     register tokens, blocks, final norm, special tokens stripped);
  4. the VGGT aggregator trunk and the encoder heads → Gaussians.

`forward_with_latent(remat=True)` is the differentiable training entry
(see there).  `forward_from_video` is the pixel-input entry (the NVS
evaluation's): the frozen Wan VAE encoder under no_grad, then
`forward_with_latent`; `StitchedConfig.vae` names the VAE's config, as in
the JAX package.  Nothing after the pre-upsample reads
`latent_t`: S = (T_vae − 1)·4 + 1 follows the clip (13 at inference, 17
in the NVS bench's second pass).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vist3a_tpu_torch.nn import aggregator as agg_mod
from vist3a_tpu_torch.nn import vit as vit_mod
from vist3a_tpu_torch.nn.encoder import (Encoder, EncoderConfig, EncoderOutput,
                                         cast_trunk_bf16, heads_pipeline)
from vist3a_tpu_torch.nn.heads import interp_matrix
from vist3a_tpu_torch.nn.layers import init_params
from vist3a_tpu_torch.nn import wan_vae
from vist3a_tpu_torch.nn.wan_vae import WanVAEConfig
from vist3a_tpu_torch.stitch.conv_spec import (ConvSpec, SpecConv,
                                               parse_conv_spec)

CANONICAL_CONV_SPEC = "conv3d_k5x3x3_o1024_s1x2x2_p2x1x1"


@dataclasses.dataclass(frozen=True)
class StitchedConfig:
    encoder: EncoderConfig = EncoderConfig()
    stitch_layer_index: int = 16         # "enc_blocks_16" → chop blocks [0,16)
    conv_spec: str = CANONICAL_CONV_SPEC
    latent_channels: int = 16            # Wan z dim
    latent_t: int = 13                   # frames after the pre-upsample
    vae: WanVAEConfig = WanVAEConfig()   # frozen Wan VAE (pixel input)

    @property
    def conv(self) -> ConvSpec:
        return parse_conv_spec(self.conv_spec)


class StitchedDecoder(nn.Module):
    """`encoder` (chopped) and `stitch_conv`: the JAX params tree's two keys."""

    def __init__(self, cfg: StitchedConfig):
        super().__init__()
        self.encoder = Encoder(cfg.encoder, vit_start=cfg.stitch_layer_index)
        self.stitch_conv = init_stitch_conv(cfg)

    def forward(self, latent: torch.Tensor, images: torch.Tensor,
                cfg: StitchedConfig, *, remat: bool = False) -> EncoderOutput:
        """The decoder on inputs already on its device, in the caller's
        grad mode (the trainer's `functional_call` enters here)."""
        lat = pre_upsample(latent, cfg)
        return stitched_forward(self, self.stitch_conv(lat), images, cfg,
                                remat=remat)


def init_stitch_conv(cfg: StitchedConfig) -> SpecConv:
    return SpecConv(cfg.conv, cfg.latent_channels)


def init(cfg: StitchedConfig, generator: torch.Generator,
         device: torch.device | str = "cuda",
         dtype: torch.dtype = torch.float32) -> StitchedDecoder:
    """A decoder with random weights of the full shapes, drawn from the JAX
    package's `init` distributions with `generator` (which must live on
    `device`).  dtype=torch.bfloat16 casts the trunk (not the heads or the
    stitch conv), as `cast_trunk_bf16` does."""
    with torch.device(device):
        model = StitchedDecoder(cfg)
    init_params(model, generator)
    if dtype == torch.bfloat16:
        cast_trunk_bf16(model.encoder)
    elif dtype != torch.float32:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    return model.eval().requires_grad_(False)


def resize_align_corners_nd(x: torch.Tensor, sizes: dict[int, int]
                            ) -> torch.Tensor:
    """Separable align_corners=True linear resize along the given axes."""
    for axis, n_out in sizes.items():
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        m = interp_matrix(n_in, n_out, x)                    # (n_out, n_in)
        x = torch.tensordot(m, x.movedim(axis, 0), dims=([1], [0])) \
            .movedim(0, axis)
    return x


def pre_upsample(latent: torch.Tensor, cfg: StitchedConfig) -> torch.Tensor:
    """(B, 16, T_vae, h, w) → (B, 16, (T_vae−1)·4+1, h, w)."""
    t_out = (latent.shape[2] - 1) * 4 + 1
    return resize_align_corners_nd(
        latent, {2: t_out, 3: latent.shape[3], 4: latent.shape[4]})


def chopped_vit_forward(vit: vit_mod.ChoppedViT, tokens: torch.Tensor,
                        grid_hw: tuple[int, int], cfg: StitchedConfig, *,
                        remat: bool = False) -> torch.Tensor:
    """Stitched tokens (N, gh·gw, D) → normalised patch tokens (N, gh·gw, D)
    in the trunk's dtype (each block recomputed in the backward with
    remat)."""
    vcfg = cfg.encoder.vit
    x = vit_mod.prepare_tokens(vit, tokens.to(vit.cls_token.dtype), grid_hw,
                               vcfg)
    return vit_mod.blocks_and_norm(vit, x, vcfg, remat=remat)


def stitched_forward(model: StitchedDecoder, stitched_tokens: torch.Tensor,
                     images: torch.Tensor, cfg: StitchedConfig, *,
                     remat: bool = False) -> EncoderOutput:
    """stitched_tokens (B, D, S, gh, gw) + images (B, 3, S, H, W) in [−1, 1];
    remat selects the training layout and recompute (see
    `forward_with_latent`)."""
    b, d, s, gh, gw = stitched_tokens.shape
    images01 = (images.transpose(1, 2) + 1.0) / 2.0         # (B,S,3,H,W)
    tok = stitched_tokens.permute(0, 2, 3, 4, 1).reshape(b * s, gh * gw, d)
    enc = model.encoder
    patch_tokens = chopped_vit_forward(enc.vit, tok, (gh, gw), cfg,
                                       remat=remat)
    tokens = agg_mod.special_tokens(enc.aggregator, patch_tokens, b, s)
    _, taps = agg_mod.run_trunk(enc.aggregator, tokens, cfg.encoder.agg,
                                (gh, gw), remat_pairs=remat)
    return heads_pipeline(enc, cfg.encoder, taps, images01, remat=remat)


def forward_with_latent(model: StitchedDecoder, latent: torch.Tensor,
                        images: torch.Tensor, cfg: StitchedConfig, *,
                        device: torch.device | str = "cuda",
                        remat: bool = False) -> EncoderOutput:
    """Wan latent (B, 16, T_vae, h, w) + images (B, 3, S, H, W) in [−1, 1]
    → EncoderOutput, computed on `device` (the inputs are moved there; the
    model must already live there).

    remat=False is the inference entry (the JAX `remat=False` path, run in
    inference mode): the padded trunk layout on the masked kernel.
    remat=True is the training entry, differentiable: the unpadded layout
    (P = 1029, every flash call unmasked), each ViT block, layer pair and
    DPT frame chunk recomputed in the backward."""
    device = torch.device(device)
    if model.stitch_conv.weight.device.type != device.type:
        raise ValueError(f"model on {model.stitch_conv.weight.device}, "
                         f"asked to run on {device}")
    latent, images = latent.to(device), images.to(device)
    if remat:
        return model(latent, images, cfg, remat=True)
    with torch.inference_mode():
        return model(latent, images, cfg)


def forward_from_video(model: StitchedDecoder,
                       vae_encoder: wan_vae.WanVAEEncoder,
                       video: torch.Tensor, images: torch.Tensor,
                       cfg: StitchedConfig, *,
                       generator: torch.Generator | None = None,
                       device: torch.device | str = "cuda") -> EncoderOutput:
    """StitchVAE3D.forward (`models/stitched_model.py:123-163`): a clip
    (B, 3, T, H, W) in [−1, 1], T ≡ 1 (mod 4), through the frozen Wan VAE
    encoder (`nn/wan_vae.py::WanVAEEncoder`, in its own dtype) under
    no_grad — the posterior sample drawn from `generator`, or its mean
    without one (the JAX package's `key=None`) — then the stitched decoder
    (`forward_with_latent`, inference entry) with the feed-forward images
    (B, 3, T, h, w) in [−1, 1]."""
    device = torch.device(device)
    dtype = next(vae_encoder.parameters()).dtype
    with torch.no_grad():
        mu, logvar = wan_vae.encode(vae_encoder, video.to(device, dtype))
        latent = mu if generator is None \
            else wan_vae.sample_posterior(mu, logvar, generator)
    return forward_with_latent(model, latent, images, cfg, device=device)
