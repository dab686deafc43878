"""The plain reference's prediction heads: camera (iterative refinement),
depth DPT, Gaussian DPT (frozen from the port's `nn/heads.py`; see
`reference/scene.py`; it imports nothing of the port).

Convs are `nn.Conv2d` / `nn.ConvTranspose2d` on NCHW activations, each
computing in its input's dtype (the heads' fp32 weights cast to it).
`gs_head_apply` returns the raw Gaussian channels channels-last,
(B, S, H, W, 84).  The DPT resizes are bilinear with align_corners=True,
applied as two interpolation-matrix products (`_interp_matrix`), and frames
run in chunks of `frames_chunk_size` (8).  The camera head computes in fp32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers import (Block, BlockConfig, LayerNorm, Linear,
                                        Mlp)


# --------------------------------------------------------------------------- #
# convs                                                                       #
# --------------------------------------------------------------------------- #
class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (weight (in, out, kh, kw)) computing in the input
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride)


# --------------------------------------------------------------------------- #
# align-corners bilinear resize as two matmuls                                #
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear align_corners=True interpolation weights."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    coords = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (coords - lo).astype(np.float32)
    m[np.arange(n_out), lo] += 1 - w
    m[np.arange(n_out), hi] += w
    return m


def interp_matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix(n_in, n_out)).to(like.device,
                                                            like.dtype)


def resize_bilinear_align_corners(x: torch.Tensor, size: tuple[int, int]
                                  ) -> torch.Tensor:
    """x: (..., H, W) → (..., oh, ow), torch align_corners=True semantics,
    with the weights in x's dtype as in the JAX package."""
    h, w = x.shape[-2:]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    out = torch.einsum("oh,...hw->...ow", interp_matrix(h, oh, x), x)
    return torch.einsum("pw,...ow->...op", interp_matrix(w, ow, x), out)


# --------------------------------------------------------------------------- #
# sinusoidal UV positional embedding                                          #
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=64)
def _uv_pos_embed(h: int, w: int, dim: int, aspect: float,
                  omega0: float = 100.0) -> np.ndarray:
    """(dim, h, w) fp32; grid spans scaled by the image aspect ratio."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = np.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w)
    ys = np.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h)
    uu, vv = np.meshgrid(xs, ys)

    def sincos(pos):
        half = dim // 4
        omega = 1.0 / omega0 ** (np.arange(half, dtype=np.float64) / half)
        out = pos.reshape(-1)[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([sincos(uu), sincos(vv)], axis=1)   # (hw, dim)
    return emb.astype(np.float32).reshape(h, w, dim).transpose(2, 0, 1)


@functools.lru_cache(maxsize=16)
def _uv_pos_embed_tensor(h: int, w: int, dim: int, aspect: float,
                         device: torch.device, dtype: torch.dtype
                         ) -> torch.Tensor:
    """`_uv_pos_embed` built once per shape, device and dtype: at the depth
    head's 448² output (128 channels, 103 MB in fp32) rebuilding it on the
    host and copying it over for every frame chunk costs more than the
    whole decode on the card."""
    return torch.from_numpy(np.ascontiguousarray(
        _uv_pos_embed(h, w, dim, aspect))).to(device, dtype)


def apply_uv_pos_embed(x: torch.Tensor, img_w: int, img_h: int,
                       ratio: float = 0.1) -> torch.Tensor:
    """x: (B, C, h, w); adds 0.1× the sinusoidal UV embedding."""
    _, c, h, w = x.shape
    pe = _uv_pos_embed_tensor(h, w, c, img_w / img_h, x.device, x.dtype)
    return x + ratio * pe[None]


# --------------------------------------------------------------------------- #
# DPT head                                                                    #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DPTConfig:
    dim_in: int = 2048
    patch_size: int = 14
    output_dim: int = 2                 # depth: 1 + conf
    features: int = 256
    out_channels: tuple = (256, 512, 1024, 1024)
    # "exp" (depth), "inv_log" (VGGT's point head), "norm_exp", "linear"
    activation: str = "exp"
    conf_activation: str = "expp1"      # or "expp0", "sigmoid"
    pos_embed: bool = True
    head2_features: int = 32
    frames_chunk_size: int = 8          # ≤0 → all frames at once


@dataclasses.dataclass(frozen=True)
class GSHeadConfig(DPTConfig):
    output_dim: int = 84                # raw_gs_dim (83) + conf
    head2_features: int = 128


class ResidualUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        return self.conv2(F.relu(out)) + x


class Fusion(nn.Module):
    def __init__(self, features: int, has_residual: bool):
        super().__init__()
        self.res1 = ResidualUnit(features) if has_residual else None
        self.res2 = ResidualUnit(features)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x, residual=None, size=None):
        if residual is not None:
            x = x + self.res1(residual)
        x = self.res2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(resize_bilinear_align_corners(x, size))


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        oc, f = cfg.out_channels, cfg.features
        self.norm = LayerNorm(cfg.dim_in)
        self.projects = nn.ModuleList(Conv2d(cfg.dim_in, oc[i], 1)
                                      for i in range(4))
        self.resize0 = ConvTranspose2d(oc[0], oc[0], 4, stride=4)
        self.resize1 = ConvTranspose2d(oc[1], oc[1], 2, stride=2)
        self.resize3 = Conv2d(oc[3], oc[3], 3, stride=2, padding=1)
        self.layer_rn = nn.ModuleList(Conv2d(oc[i], f, 3, padding=1,
                                             bias=False) for i in range(4))
        self.refinenet1 = Fusion(f, True)
        self.refinenet2 = Fusion(f, True)
        self.refinenet3 = Fusion(f, True)
        self.refinenet4 = Fusion(f, False)
        self.output_conv1 = Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.ModuleList([
            Conv2d(f // 2, cfg.head2_features, 3, padding=1),
            Conv2d(cfg.head2_features, cfg.output_dim, 1)])


class GSHead(DPTHead):
    """DPT plus the 7×7 RGB `input_merger` skip."""

    def __init__(self, cfg: GSHeadConfig):
        super().__init__(cfg)
        self.input_merger = Conv2d(3, cfg.features // 2, 7, padding=3)


def _dpt_fused_features(head: DPTHead, taps, cfg: DPTConfig,
                        patch_start_idx: int, img_hw: tuple[int, int]):
    """4 × (N, P, 2C) taps → refinenet cascade + output_conv1, NCHW."""
    h, w = img_hw
    ph, pw = h // cfg.patch_size, w // cfg.patch_size
    outs = []
    for i, tap in enumerate(taps):
        n, _, c = tap.shape
        x = head.norm(tap[:, patch_start_idx:])
        x = x.transpose(1, 2).reshape(n, c, ph, pw)
        x = head.projects[i](x)
        if cfg.pos_embed:
            x = apply_uv_pos_embed(x, w, h)
        if i == 0:
            x = head.resize0(x)
        elif i == 1:
            x = head.resize1(x)
        elif i == 3:
            x = head.resize3(x)
        outs.append(x)
    l1, l2, l3, l4 = [head.layer_rn[i](o) for i, o in enumerate(outs)]
    out = head.refinenet4(l4, size=l3.shape[-2:])
    out = head.refinenet3(out, l3, size=l2.shape[-2:])
    out = head.refinenet2(out, l2, size=l1.shape[-2:])
    out = head.refinenet1(out, l1)
    return head.output_conv1(out)


def _frame_chunks(n: int, chunk: int):
    if chunk <= 0 or chunk >= n:
        return [(0, n)]
    return [(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def _dpt_frames(head: DPTHead, taps_flat, images_hw, patch_start_idx,
                cfg: DPTConfig):
    h, w = images_hw
    out = _dpt_fused_features(head, taps_flat, cfg, patch_start_idx,
                              images_hw)
    ph, pw = h // cfg.patch_size, w // cfg.patch_size
    out = resize_bilinear_align_corners(
        out, (ph * cfg.patch_size, pw * cfg.patch_size))
    if cfg.pos_embed:
        out = apply_uv_pos_embed(out, w, h)
    out = head.output_conv2[0](out)
    return head.output_conv2[1](F.relu(out))


def dpt_apply(head: DPTHead, taps, images_hw: tuple[int, int],
              patch_start_idx: int, cfg: DPTConfig,
              batch_seq: tuple[int, int]):
    """Depth-style DPT: returns (preds (B,S,H,W,C−1), conf (B,S,H,W)),
    activated in fp32 whatever the cascade dtype (`_activate`)."""
    h, w = images_hw
    b, s = batch_seq
    taps_flat = [t.reshape(b * s, *t.shape[2:]) for t in taps]

    chunks = [_dpt_frames(head, [t[lo:hi] for t in taps_flat], images_hw,
                          patch_start_idx, cfg)
              for lo, hi in _frame_chunks(b * s, cfg.frames_chunk_size)]
    out = torch.cat(chunks)
    preds, conf = _activate(out.float().permute(0, 2, 3, 1), cfg)
    return preds.reshape(b, s, h, w, -1), conf.reshape(b, s, h, w)


def _activate(fmap: torch.Tensor, cfg: DPTConfig):
    """(…, C) fp32 → (preds (…, C−1), conf (…)) by `cfg.activation` and
    `cfg.conf_activation` (`heads/head_act.py:61-112`)."""
    xyz, conf = fmap[..., :-1], fmap[..., -1]
    if cfg.activation == "exp":
        preds = torch.exp(xyz)
    elif cfg.activation == "norm_exp":
        d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True) \
            .clamp_min(1e-8)
        preds = xyz / d * torch.expm1(d)
    elif cfg.activation == "inv_log":
        preds = torch.sign(xyz) * torch.expm1(torch.abs(xyz))
    elif cfg.activation == "linear":
        preds = xyz
    else:
        raise ValueError(cfg.activation)
    if cfg.conf_activation == "expp1":
        conf = 1 + torch.exp(conf)
    elif cfg.conf_activation == "expp0":
        conf = torch.exp(conf)
    elif cfg.conf_activation == "sigmoid":
        conf = torch.sigmoid(conf)
    else:
        raise ValueError(cfg.conf_activation)
    return preds, conf


def _gs_frames(head: GSHead, taps_flat, imgs, cfg: GSHeadConfig,
               patch_start_idx: int):
    """imgs: (N, 3, H, W)."""
    h, w = imgs.shape[-2:]
    out = _dpt_fused_features(head, taps_flat, cfg, patch_start_idx, (h, w))
    direct = F.relu(head.input_merger(imgs.to(out.dtype)))
    out = resize_bilinear_align_corners(out, (h, w)) + direct
    if cfg.pos_embed:
        out = apply_uv_pos_embed(out, w, h)
    out = head.output_conv2[0](out)
    return head.output_conv2[1](F.relu(out))


def gs_head_apply(head: GSHead, taps, images: torch.Tensor,
                  patch_start_idx: int, cfg: GSHeadConfig) -> torch.Tensor:
    """images (B, S, 3, H, W) in [0, 1] → raw (B, S, H, W, output_dim)
    fp32."""
    b, s, _, h, w = images.shape
    taps_flat = [t.reshape(b * s, *t.shape[2:]) for t in taps]
    imgs = images.reshape(b * s, 3, h, w)

    chunks = [_gs_frames(head, [t[lo:hi] for t in taps_flat], imgs[lo:hi],
                         cfg, patch_start_idx)
              for lo, hi in _frame_chunks(b * s, cfg.frames_chunk_size)]
    out = torch.cat(chunks)
    return out.float().permute(0, 2, 3, 1).reshape(b, s, h, w, cfg.output_dim)


# --------------------------------------------------------------------------- #
# camera head                                                                 #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CameraHeadConfig:
    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    target_dim: int = 9
    num_iterations: int = 4

    def block_config(self) -> BlockConfig:
        return BlockConfig(dim=self.dim_in, num_heads=self.num_heads,
                           mlp_ratio=self.mlp_ratio, layerscale=0.01,
                           ln_eps=1e-5)


class CameraHead(nn.Module):
    def __init__(self, cfg: CameraHeadConfig):
        super().__init__()
        self.trunk = nn.ModuleList(Block(cfg.block_config())
                                   for _ in range(cfg.trunk_depth))
        self.token_norm = LayerNorm(cfg.dim_in)
        self.trunk_norm = LayerNorm(cfg.dim_in)
        self.empty_pose_tokens = nn.Parameter(
            torch.empty(1, 1, cfg.target_dim))
        self.embed_pose = Linear(cfg.target_dim, cfg.dim_in)
        self.modulation = Linear(cfg.dim_in, 3 * cfg.dim_in)
        self.pose_branch = Mlp(cfg.dim_in, cfg.dim_in // 2, cfg.target_dim)

def camera_head_apply(head: CameraHead, last_tap: torch.Tensor,
                      cfg: CameraHeadConfig) -> list[torch.Tensor]:
    """last_tap (B, S, P, 2C) → per-iteration activated pose encodings,
    each (B, S, 9), in fp32."""
    pose_tokens = head.token_norm(last_tap[:, :, 0].float())
    b, s, _ = pose_tokens.shape
    normed = F.layer_norm(pose_tokens, (pose_tokens.shape[-1],), eps=1e-6)
    preds, pred = [], None
    for _ in range(cfg.num_iterations):
        module_input = (head.empty_pose_tokens.float().expand(
            b, s, cfg.target_dim) if pred is None else pred.detach())
        mod = head.modulation(F.silu(head.embed_pose(module_input)))
        shift, scale, gate = mod.chunk(3, dim=-1)
        x = gate * (normed * (1 + scale) + shift) + pose_tokens
        for blk in head.trunk:
            x = blk(x)
        delta = head.pose_branch(head.trunk_norm(x))
        pred = delta if pred is None else pred + delta
        preds.append(torch.cat([pred[..., :7], F.relu(pred[..., 7:])], -1))
    return preds
