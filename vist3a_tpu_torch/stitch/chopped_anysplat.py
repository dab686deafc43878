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

The pixel-input `forward_from_video` needs the Wan VAE and is not ported
here; `StitchedConfig` therefore has no `vae` field.
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
from vist3a_tpu_torch.stitch.conv_spec import (ConvSpec, SpecConv,
                                               parse_conv_spec)

CANONICAL_CONV_SPEC = "conv3d_k5x3x3_o1024_s1x2x2_p2x1x1"


@dataclasses.dataclass(frozen=True)
class StitchedConfig:
    encoder: EncoderConfig = EncoderConfig()
    stitch_layer_index: int = 16         # "enc_blocks_16" → chop blocks [0,16)
    conv_spec: str = CANONICAL_CONV_SPEC
    latent_channels: int = 16            # Wan z dim

    @property
    def conv(self) -> ConvSpec:
        return parse_conv_spec(self.conv_spec)


class StitchedDecoder(nn.Module):
    """`encoder` (chopped) and `stitch_conv`: the JAX params tree's two keys."""

    def __init__(self, cfg: StitchedConfig):
        super().__init__()
        self.encoder = Encoder(cfg.encoder, vit_start=cfg.stitch_layer_index)
        self.stitch_conv = init_stitch_conv(cfg)


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
                        grid_hw: tuple[int, int], cfg: StitchedConfig
                        ) -> torch.Tensor:
    """Stitched tokens (N, gh·gw, D) → normalised patch tokens (N, gh·gw, D)
    in the trunk's dtype."""
    vcfg = cfg.encoder.vit
    tokens = tokens.to(vit.cls_token.dtype)
    n, _, d = tokens.shape
    x = torch.cat([vit.cls_token.expand(n, 1, d), tokens], dim=1)
    x = x + vit_mod.interpolate_pos_embed(vit.pos_embed, *grid_hw).to(x.dtype)
    reg = vit.register_tokens.expand(n, vcfg.num_register_tokens, d)
    x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    for blk in vit.blocks.values():
        x = blk(x)
    return vit.norm(x)[:, 1 + vcfg.num_register_tokens:]


def stitched_forward(model: StitchedDecoder, stitched_tokens: torch.Tensor,
                     images: torch.Tensor, cfg: StitchedConfig
                     ) -> EncoderOutput:
    """stitched_tokens (B, D, S, gh, gw) + images (B, 3, S, H, W) in [−1, 1]."""
    b, d, s, gh, gw = stitched_tokens.shape
    images01 = (images.transpose(1, 2) + 1.0) / 2.0         # (B,S,3,H,W)
    tok = stitched_tokens.permute(0, 2, 3, 4, 1).reshape(b * s, gh * gw, d)
    enc = model.encoder
    patch_tokens = chopped_vit_forward(enc.vit, tok, (gh, gw), cfg)

    agg = enc.aggregator
    cam = agg_mod.expand_special_tokens(
        agg.camera_token.to(patch_tokens.dtype), b, s)
    reg = agg_mod.expand_special_tokens(
        agg.register_token.to(patch_tokens.dtype), b, s)
    tokens = torch.cat([cam, reg, patch_tokens], dim=1).reshape(b, s, -1, d)
    _, taps = agg_mod.run_trunk(agg, tokens, cfg.encoder.agg, (gh, gw))
    return heads_pipeline(enc, cfg.encoder, taps, images01)


@torch.inference_mode()
def forward_with_latent(model: StitchedDecoder, latent: torch.Tensor,
                        images: torch.Tensor, cfg: StitchedConfig, *,
                        device: torch.device | str = "cuda") -> EncoderOutput:
    """Wan latent (B, 16, T_vae, h, w) + images (B, 3, S, H, W) in [−1, 1]
    → EncoderOutput, computed on `device` (the inputs are moved there; the
    model must already live there)."""
    device = torch.device(device)
    if model.stitch_conv.weight.device.type != device.type:
        raise ValueError(f"model on {model.stitch_conv.weight.device}, "
                         f"asked to run on {device}")
    latent, images = latent.to(device), images.to(device)
    lat = pre_upsample(latent, cfg)
    return stitched_forward(model, model.stitch_conv(lat), images, cfg)
