"""The plain reference's stitched decoder: chopped AnySplat behind a conv3d
stitching layer (frozen from the port's `stitch/chopped_anysplat.py`; see
`reference/scene.py`; it imports nothing of the port).

`forward_with_latent` takes an un-normalised Wan latent (B, 16, T_vae, h,
w) and feed-forward images (B, 3, S, H, W) in [−1, 1]:

  1. trilinear align_corners=True pre-upsample of the latent to
     S = (T_vae − 1)·4 + 1 frames (`pre_upsample`);
  2. the conv3d stitch (`conv_spec`) → (B, 1024, S, H/14, W/14) tokens;
  3. the DINOv2 blocks after the chop (cls token, interpolated pos-embed,
     register tokens, blocks, final norm, special tokens stripped);
  4. the VGGT aggregator trunk and the encoder heads → Gaussians.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from port_bench.reference import aggregator as agg_mod
from port_bench.reference import vit as vit_mod
from port_bench.reference.encoder import (Encoder, EncoderConfig, EncoderOutput,
                                         heads_pipeline)
from port_bench.reference.heads import interp_matrix
from port_bench.reference.wan_vae import WanVAEConfig
from port_bench.reference.conv_spec import (ConvSpec, SpecConv,
                                               parse_conv_spec)

CANONICAL_CONV_SPEC = "conv3d_k5x3x3_o1024_s1x2x2_p2x1x1"


@dataclasses.dataclass(frozen=True)
class StitchedConfig:
    encoder: EncoderConfig = EncoderConfig()
    stitch_layer_index: int = 16         # "enc_blocks_16" → chop blocks [0,16)
    conv_spec: str = CANONICAL_CONV_SPEC
    latent_channels: int = 16            # Wan z dim
    latent_t: int = 13                   # frames after the pre-upsample
    vae: WanVAEConfig = WanVAEConfig()

    @property
    def conv(self) -> ConvSpec:
        return parse_conv_spec(self.conv_spec)


class StitchedDecoder(nn.Module):
    """`encoder` (chopped) and `stitch_conv`."""

    def __init__(self, cfg: StitchedConfig):
        super().__init__()
        self.encoder = Encoder(cfg.encoder, vit_start=cfg.stitch_layer_index)
        self.stitch_conv = init_stitch_conv(cfg)

    def forward(self, latent: torch.Tensor, images: torch.Tensor,
                cfg: StitchedConfig) -> EncoderOutput:
        """The decoder on inputs already on its device."""
        lat = pre_upsample(latent, cfg)
        return stitched_forward(self, self.stitch_conv(lat), images, cfg)


def init_stitch_conv(cfg: StitchedConfig) -> SpecConv:
    return SpecConv(cfg.conv, cfg.latent_channels)


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
                        grid_hw: tuple[int, int],
                        cfg: StitchedConfig) -> torch.Tensor:
    """Stitched tokens (N, gh·gw, D) → normalised patch tokens (N, gh·gw, D)
    in the trunk's dtype."""
    vcfg = cfg.encoder.vit
    x = vit_mod.prepare_tokens(vit, tokens.to(vit.cls_token.dtype), grid_hw,
                               vcfg)
    return vit_mod.blocks_and_norm(vit, x, vcfg)


def stitched_forward(model: StitchedDecoder, stitched_tokens: torch.Tensor,
                     images: torch.Tensor,
                     cfg: StitchedConfig) -> EncoderOutput:
    """stitched_tokens (B, D, S, gh, gw) + images (B, 3, S, H, W) in
    [−1, 1]."""
    b, d, s, gh, gw = stitched_tokens.shape
    images01 = (images.transpose(1, 2) + 1.0) / 2.0         # (B,S,3,H,W)
    tok = stitched_tokens.permute(0, 2, 3, 4, 1).reshape(b * s, gh * gw, d)
    enc = model.encoder
    patch_tokens = chopped_vit_forward(enc.vit, tok, (gh, gw), cfg)
    tokens = agg_mod.special_tokens(enc.aggregator, patch_tokens, b, s)
    _, taps = agg_mod.run_trunk(enc.aggregator, tokens, cfg.encoder.agg,
                                (gh, gw))
    return heads_pipeline(enc, cfg.encoder, taps, images01)


def forward_with_latent(model: StitchedDecoder, latent: torch.Tensor,
                        images: torch.Tensor, cfg: StitchedConfig, *,
                        device: torch.device | str = "cuda") -> EncoderOutput:
    """Wan latent (B, 16, T_vae, h, w) + images (B, 3, S, H, W) in [−1, 1]
    → EncoderOutput, computed on `device` (the model lives there)."""
    device = torch.device(device)
    latent, images = latent.to(device), images.to(device)
    with torch.inference_mode():
        return model(latent, images, cfg)
