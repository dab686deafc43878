"""AnySplat encoder heads: taps → camera/depth/GS heads → Gaussians.

Port of the head half of `vist3a_tpu/nn/encoder.py`, shared by the stitched
decoder: the camera head (fp32, 4 refinements) gives extrinsics and
intrinsics; the depth DPT gives depth and confidence, unprojected to world
points; the GS DPT gives 83 raw Gaussian channels and a confidence; the
confidence mask is a global quantile, folded into opacity so every pixel
stays resident (G = S·H·W, static); the unified adapter calibrates the
Gaussians; the context pose is c2w 4×4 plus width/height-normalised K.

`pred_head_type` picks the geometry: "depth" (the deployed VIST3A path)
unprojects the depth head's depth; "point" takes world points straight
from VGGT's point head (`anysplat.py:108,428-433`; an `Encoder` built so
holds a `point_head`), its confidence as `depth_conf` and their z as the
depth, as the JAX package completes the reference's branch.  `forward` is
the full (un-chopped) encoder from images, the frozen distillation
teacher: an `Encoder` built with vit_start=0 holds the whole DINOv2 trunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from vist3a_tpu_torch.core import mesh as mesh_mod
from vist3a_tpu_torch.nn import aggregator as agg_mod
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
from vist3a_tpu_torch.nn.vit import VIT_LARGE, ViT, ChoppedViT, ViTConfig


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
    2^24-element limit (the global batch of a wide data axis) the same
    interpolation over a sort."""
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
    """The encoder's modules, with the ViT chopped at `vit_start` (0: the
    whole trunk with its patch embedding)."""

    def __init__(self, cfg: EncoderConfig, vit_start: int = 0):
        super().__init__()
        self.vit = ViT(cfg.vit) if vit_start == 0 else \
            ChoppedViT(cfg.vit, vit_start)
        self.aggregator = Aggregator(cfg.agg)
        self.camera_head = CameraHead(cfg.camera)
        self.depth_head = DPTHead(cfg.depth)
        self.gs_head = GSHead(cfg.gs)
        if cfg.pred_head_type == "point":
            self.point_head = DPTHead(cfg.point)


def cast_trunk_bf16(encoder: Encoder) -> Encoder:
    """Cast, in place, every submodule whose name lacks "head" to bf16 (the
    reference's `cast_to_bfloat16`); the heads keep fp32 weights."""
    for name, child in encoder.named_children():
        if "head" not in name:
            child.to(torch.bfloat16)
    return encoder


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def heads_pipeline(encoder: Encoder, cfg: EncoderConfig, taps: list,
                   images01: torch.Tensor, *,
                   remat: bool = False) -> EncoderOutput:
    """taps (4 × (B,S,P,2C)) + images (B,S,3,H,W) in [0,1] → EncoderOutput;
    with remat the DPT frame chunks are recomputed in the backward."""
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
                                    cfg.point, (b, s), remat=remat)
        depth = pts[..., 2:3]
    elif cfg.pred_head_type == "depth":
        depth, depth_conf = dpt_apply(encoder.depth_head, taps, (h, w), psi,
                                      cfg.depth, (b, s), remat=remat)
        pts = unproject_depth(depth, extrinsic, intrinsic)   # (B,S,H,W,3)
    else:
        raise ValueError(f"pred_head_type {cfg.pred_head_type!r}")

    # over the global batch on a data-parallel mesh (`core/mesh.py::
    # global_batch`), as the JAX package's quantile over its global batch
    conf_valid = depth_conf > quantile(
        mesh_mod.global_batch(depth_conf).flatten(), cfg.conf_threshold)

    raw = gs_head_apply(encoder.gs_head, taps, images01, psi, cfg.gs,
                        remat=remat)
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


def forward(encoder: Encoder, images01: torch.Tensor, cfg: EncoderConfig, *,
            remat: bool = True) -> EncoderOutput:
    """The full encoder (vit_start=0), the frozen distillation teacher:
    images (B, S, 3, H, W) in [0, 1] → EncoderOutput.  remat=True (the JAX
    default) is the training layout: the unpadded trunk, every flash call
    unmasked; without grad mode nothing is recomputed."""
    taps = agg_mod.forward(encoder.aggregator, encoder.vit, images01,
                           cfg.agg, cfg.vit, remat=remat)
    return heads_pipeline(encoder, cfg, taps, images01, remat=remat)
