"""AnySplat encoder heads: taps → camera/depth/GS heads → Gaussians.

Port of the head half of `vist3a_tpu/nn/encoder.py`, shared by the stitched
decoder: the camera head (fp32, 4 refinements) gives extrinsics and
intrinsics; the depth DPT gives depth and confidence, unprojected to world
points; the GS DPT gives 83 raw Gaussian channels and a confidence; the
confidence mask is a global quantile, folded into opacity so every pixel
stays resident (G = S·H·W, static); the unified adapter calibrates the
Gaussians; the context pose is c2w 4×4 plus width/height-normalised K.

The depth-head path ("depth", the deployed VIST3A path) is the one ported;
the JAX package's `pred_head_type="point"` branch is not.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from vist3a_tpu_torch.nn.aggregator import Aggregator, AggregatorConfig
from vist3a_tpu_torch.nn.gaussians import (Gaussians, map_pdf_to_opacity,
                                           unified_gaussian_adapter)
from vist3a_tpu_torch.nn.geometry import (closed_form_inverse_se3,
                                          pose_encoding_to_extri_intri,
                                          unproject_depth)
from vist3a_tpu_torch.nn.heads import (CameraHead, CameraHeadConfig, DPTConfig,
                                       DPTHead, GSHead, GSHeadConfig,
                                       camera_head_apply, dpt_apply,
                                       gs_head_apply)
from vist3a_tpu_torch.nn.vit import VIT_LARGE, ChoppedViT, ViTConfig


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vit: ViTConfig = VIT_LARGE
    agg: AggregatorConfig = AggregatorConfig()
    camera: CameraHeadConfig = CameraHeadConfig()
    depth: DPTConfig = DPTConfig()
    gs: GSHeadConfig = GSHeadConfig(output_dim=84, head2_features=128,
                                    pos_embed=False)
    sh_degree: int = 4
    conf_threshold: float = 0.1         # confidence quantile masked out
    # DPT-cascade activation dtype: "float32" (the reference) or "bfloat16"
    # (the inference decode).  Activations, quantile and assembly stay fp32.
    head_dtype: str = "float32"

    @property
    def raw_gs_dim(self) -> int:
        return self.gs.output_dim - 1


class EncoderOutput(NamedTuple):
    gaussians: Gaussians
    pred_pose_enc_list: list
    extrinsic_c2w: torch.Tensor     # (B, S, 4, 4)
    intrinsic_norm: torch.Tensor    # (B, S, 3, 3), fx/W fy/H normalised
    depth: torch.Tensor             # (B, S, H, W, 1)
    depth_conf: torch.Tensor        # (B, S, H, W)
    conf_valid_mask: torch.Tensor   # (B, S, H, W) bool
    scene_scale: torch.Tensor       # ()
    anchor_feats: torch.Tensor      # (B, S, raw_gs_dim, H, W) view
    gs_conf: torch.Tensor           # (B, S, H, W)


class Encoder(nn.Module):
    """The encoder's modules, with the ViT chopped at `vit_start`."""

    def __init__(self, cfg: EncoderConfig, vit_start: int = 0):
        super().__init__()
        self.vit = ChoppedViT(cfg.vit, vit_start)
        self.aggregator = Aggregator(cfg.agg)
        self.camera_head = CameraHead(cfg.camera)
        self.depth_head = DPTHead(cfg.depth)
        self.gs_head = GSHead(cfg.gs)


def cast_trunk_bf16(encoder: Encoder) -> Encoder:
    """Cast, in place, every submodule whose name lacks "head" to bf16 (the
    reference's `cast_to_bfloat16`); the heads keep fp32 weights."""
    for name, child in encoder.named_children():
        if "head" not in name:
            child.to(torch.bfloat16)
    return encoder


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def heads_pipeline(encoder: Encoder, cfg: EncoderConfig, taps: list,
                   images01: torch.Tensor) -> EncoderOutput:
    """taps (4 × (B,S,P,2C)) + images (B,S,3,H,W) in [0,1] → EncoderOutput."""
    b, s, _, h, w = images01.shape
    psi = cfg.agg.patch_start_idx
    pose_enc_list = camera_head_apply(encoder.camera_head, taps[-1],
                                      cfg.camera)

    hdt = _DTYPES[cfg.head_dtype]
    taps = [t.to(hdt) for t in taps]
    images01 = images01.to(hdt)
    extrinsic, intrinsic = pose_encoding_to_extri_intri(pose_enc_list[-1],
                                                        (h, w))
    depth, depth_conf = dpt_apply(encoder.depth_head, taps, (h, w), psi,
                                  cfg.depth, (b, s))
    pts = unproject_depth(depth, extrinsic, intrinsic)       # (B,S,H,W,3)

    conf_valid = depth_conf > torch.quantile(depth_conf.flatten(),
                                             cfg.conf_threshold)

    raw = gs_head_apply(encoder.gs_head, taps, images01, psi, cfg.gs)
    gs_conf = raw[..., cfg.raw_gs_dim]
    anchor_feats = raw[..., :cfg.raw_gs_dim].movedim(-1, 2)
    scene_scale = torch.linalg.norm(pts.reshape(b, -1, 3), dim=-1).mean() \
        .clamp_min(1e-8)

    feats = raw[..., :cfg.raw_gs_dim].reshape(b, -1, cfg.raw_gs_dim)
    opacity = map_pdf_to_opacity(torch.sigmoid(feats[..., 0])) \
        * conf_valid.reshape(b, -1)
    gaussians = unified_gaussian_adapter(pts.reshape(b, -1, 3), opacity,
                                         feats[..., 1:], cfg.sh_degree)

    pad = extrinsic.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(b, s, 1, 4)
    c2w = closed_form_inverse_se3(torch.cat([extrinsic, pad], dim=2))
    scale = intrinsic.new_tensor([[1.0 / w], [1.0 / h], [1.0]])
    return EncoderOutput(
        gaussians=gaussians, pred_pose_enc_list=pose_enc_list,
        extrinsic_c2w=c2w, intrinsic_norm=intrinsic * scale, depth=depth,
        depth_conf=depth_conf, conf_valid_mask=conf_valid,
        scene_scale=scene_scale, anchor_feats=anchor_feats, gs_conf=gs_conf)
