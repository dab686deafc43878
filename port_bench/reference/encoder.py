"""The plain reference's AnySplat encoder heads: taps → camera, depth and
GS heads → Gaussians (frozen from the port's `nn/encoder.py`; see
`reference/scene.py`; it imports nothing of the port).

The camera head (fp32, 4 refinements) gives extrinsics and intrinsics; the
depth DPT gives depth and confidence, unprojected to world points ("point"
takes world points from VGGT's point head instead); the GS DPT gives 83 raw
Gaussian channels and a confidence; the confidence mask is the
`conf_threshold` quantile of the depth confidence, folded into opacity so
every pixel stays (G = S·H·W); the unified adapter calibrates the
Gaussians; the cameras are c2w 4×4 plus width/height-normalised K.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from port_bench.reference.aggregator import Aggregator, AggregatorConfig
from port_bench.reference.gaussians import (Gaussians, map_pdf_to_opacity,
                                           unified_gaussian_adapter)
from port_bench.reference.geometry import (closed_form_inverse_se3,
                                          pose_encoding_to_extri_intri,
                                          unproject_depth)
from port_bench.reference.heads import (CameraHead, CameraHeadConfig, DPTConfig,
                                       DPTHead, GSHead, GSHeadConfig,
                                       camera_head_apply, dpt_apply,
                                       gs_head_apply)
from port_bench.reference.vit import VIT_LARGE, ChoppedViT, ViTConfig


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vit: ViTConfig = VIT_LARGE
    agg: AggregatorConfig = AggregatorConfig()
    camera: CameraHeadConfig = CameraHeadConfig()
    depth: DPTConfig = DPTConfig()
    # VGGT-1B's `point_head`: DPTHead(output_dim=4, activation="inv_log")
    point: DPTConfig = DPTConfig(activation="inv_log",
                                 conf_activation="expp1", output_dim=4)
    gs: GSHeadConfig = GSHeadConfig(output_dim=84, head2_features=128,
                                    pos_embed=False)
    sh_degree: int = 4
    pred_head_type: str = "depth"       # or "point"
    conf_threshold: float = 0.1         # confidence quantile masked out
    # DPT-cascade activation dtype: "float32" (the reference) or "bfloat16"
    # (the inference decode).  Activations, quantile and assembly stay fp32.
    head_dtype: str = "float32"

    @property
    def raw_gs_dim(self) -> int:
        return self.gs.output_dim - 1


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`torch.quantile` (linear interpolation) of a 1-D tensor; past its
    2^24-element limit the same interpolation over a sort."""
    if x.numel() <= 1 << 24:
        return torch.quantile(x, q)
    s = torch.sort(x).values
    pos = q * (x.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, x.numel() - 1)
    return torch.lerp(s[lo], s[hi], pos - lo)


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

    def __init__(self, cfg: EncoderConfig, vit_start: int):
        super().__init__()
        self.vit = ChoppedViT(cfg.vit, vit_start)
        self.aggregator = Aggregator(cfg.agg)
        self.camera_head = CameraHead(cfg.camera)
        self.depth_head = DPTHead(cfg.depth)
        self.gs_head = GSHead(cfg.gs)
        if cfg.pred_head_type == "point":
            self.point_head = DPTHead(cfg.point)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def heads_pipeline(encoder: Encoder, cfg: EncoderConfig, taps: list,
                   images01: torch.Tensor) -> EncoderOutput:
    """taps (4 × (B,S,P,2C)) + images (B,S,3,H,W) in [0,1] →
    EncoderOutput."""
    b, s, _, h, w = images01.shape
    psi = cfg.agg.patch_start_idx
    pose_enc_list = camera_head_apply(encoder.camera_head, taps[-1],
                                      cfg.camera)

    hdt = _DTYPES[cfg.head_dtype]
    taps = [t.to(hdt) for t in taps]
    images01 = images01.to(hdt)
    extrinsic, intrinsic = pose_encoding_to_extri_intri(pose_enc_list[-1],
                                                        (h, w))
    if cfg.pred_head_type == "point":
        pts, depth_conf = dpt_apply(encoder.point_head, taps, (h, w), psi,
                                    cfg.point, (b, s))
        depth = pts[..., 2:3]
    elif cfg.pred_head_type == "depth":
        depth, depth_conf = dpt_apply(encoder.depth_head, taps, (h, w), psi,
                                      cfg.depth, (b, s))
        pts = unproject_depth(depth, extrinsic, intrinsic)   # (B,S,H,W,3)
    else:
        raise ValueError(f"pred_head_type {cfg.pred_head_type!r}")

    conf_valid = depth_conf > quantile(
        depth_conf.flatten(), cfg.conf_threshold)

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


