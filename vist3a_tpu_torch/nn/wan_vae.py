"""Wan 2.1 causal-3D VAE: the decoder and the encoder.

Port of `vist3a_tpu/nn/wan_vae.py`: causal conv3d with the time axis padded
2·pad_t at the front only, channel RMSNorm, residual blocks, the mid block
with single-head per-frame spatial attention, and the 2D/3D resample blocks,
run over the full sequence (the JAX package's closed form of the
reference's chunked loops: in `upsample3d` frame 0 passes through and the
time conv never sees it; in `downsample3d` frame 0 passes through and the
stride-2 time conv's windows start at frame 0).  `encode` and
`sample_posterior` give the distillation trainer its latents; the encoder
has no attention blocks outside its mid block (the JAX `attn_scales` is
empty for Wan 2.1 and is not ported).

The JAX package computes channels-last; the port keeps PyTorch's
channels-first (B, C, T, H, W) throughout, which is also the public layout
of `decode`.  Convolutions go to `F.conv3d` (cuDNN on the card), as XLA
computes them outside any Pallas kernel there; the attention block is plain
matmul-softmax-matmul, as the JAX package runs it (`impl="xla"`).  Each
conv casts its weight to the activation dtype and adds the bias after the
product, in that dtype, as the JAX package does.

Weights come from `convert.load_jax_vae_params` or from `init_decoder` /
`init_encoder`, which draw them from the JAX `init` distributions.

`decode(remat=True)` recomputes each residual block, the mid block's
attention and the finest-resolution tail in the backward, as the JAX
package's `jax.checkpoint`s do (`wan_vae.py:230-237`, `:371-398`): the VDM
step's reward path decodes with grad through 13 frames of 512², in bf16
activations over fp32 weights (each conv casts its weight to the
activation dtype).  The JAX encoder's remat (`:329-343`) has no
counterpart: the port's encode of the frozen VAE runs without grad, so a
recompute would have nothing to save.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from vist3a_tpu_torch.nn.layers import build_random, recompute
from vist3a_tpu_torch.ops.attention import plain_attention

LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: tuple = (False, True, True)

    @property
    def temperal_upsample(self) -> tuple:
        return self.temperal_downsample[::-1]

    @property
    def enc_dims(self) -> tuple:
        return tuple(self.base_dim * u for u in (1,) + tuple(self.dim_mult))

    @property
    def dec_dims(self) -> tuple:
        m = tuple(self.dim_mult)
        return tuple(self.base_dim * u for u in (m[-1],) + m[::-1])


class _Conv(nn.Module):
    """Weight (out, in, *k) and bias, uniform ±1/√fan_in at init."""

    def __init__(self, ci: int, co: int, k: tuple):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci, *k))
        self.bias = nn.Parameter(torch.empty(co))

    def init_params(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(math.prod(self.weight.shape[1:]))
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def _bias(self, x: torch.Tensor) -> torch.Tensor:
        return self.bias.to(x.dtype)[:, None, None, None]


class CausalConv3d(_Conv):
    """Time padded 2·pad_t at the front only; H and W padded symmetrically
    with zeros; weight (out, in, kt, kh, kw)."""

    def __init__(self, ci: int, co: int, k: tuple = (3, 3, 3),
                 pad: tuple = (1, 1, 1), stride: tuple = (1, 1, 1)):
        super().__init__(ci, co, k)
        self.pad = pad
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pt, ph, pw = self.pad
        if pt:
            x = F.pad(x, (0, 0, 0, 0, 2 * pt, 0))
        y = F.conv3d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=(0, ph, pw))
        return y + self._bias(x)


class Conv2dFrames(_Conv):
    """A 2D conv applied to every frame of (B, C, T, H, W); weight
    (out, in, k, k), run as a conv3d with a kernel one frame deep."""

    def __init__(self, ci: int, co: int, k: int, pad: int, stride: int = 1):
        super().__init__(ci, co, (k, k))
        self.pad = pad
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x, self.weight.to(x.dtype)[:, :, None],
                     stride=(1, self.stride, self.stride),
                     padding=(0, self.pad, self.pad))
        return y + self._bias(x)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-12) -> torch.Tensor:
    """`F.normalize(x, dim=C)·√C·gamma` over dim 1: the norm is reduced in
    fp32, the rescale runs in the input dtype."""
    norm = torch.linalg.vector_norm(x.float(), dim=1, keepdim=True)
    scale = (math.sqrt(x.shape[1]) / torch.clamp_min(norm, eps)).to(x.dtype)
    return x * scale * gamma.to(x.dtype)[:, None, None, None]


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


class ResidualBlock(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.norm1 = RMSNorm(ci)
        self.conv1 = CausalConv3d(ci, co)
        self.norm2 = RMSNorm(co)
        self.conv2 = CausalConv3d(co, co)
        self.conv_shortcut = CausalConv3d(ci, co, (1, 1, 1), (0, 0, 0)) \
            if ci != co else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.conv_shortcut is None else self.conv_shortcut(x)
        x = self.conv1(F.silu(self.norm1(x)))
        x = self.conv2(F.silu(self.norm2(x)))
        return x + h


class AttentionBlock(nn.Module):
    """Single-head spatial attention within each frame."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.to_qkv = Conv2dFrames(dim, 3 * dim, 1, 0)
        self.proj = Conv2dFrames(dim, dim, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        qkv = self.to_qkv(self.norm(x))                   # (B, 3C, T, H, W)
        qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 3 * c)
        q, k, v = (y[:, :, None, :] for y in qkv.chunk(3, dim=-1))
        o = plain_attention(q, k, v)                      # (B·T, HW, 1, C)
        o = o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return self.proj(o) + x


class MidBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResidualBlock(dim, dim),
                                      ResidualBlock(dim, dim)])
        self.attentions = nn.ModuleList([AttentionBlock(dim)])

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        for blk in (self.resnets[0], self.attentions[0], self.resnets[1]):
            x = _maybe_recompute(blk, x, remat)
        return x


def _call(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return module(x)


def _maybe_recompute(module: nn.Module, x: torch.Tensor,
                     remat: bool) -> torch.Tensor:
    """module(x), recomputed in the backward when remat."""
    return recompute(_call, module, x) if remat else module(x)


def _interleave_time(x: torch.Tensor) -> torch.Tensor:
    """(B, 2C, T, H, W) → (B, C, 2T, H, W): frame 2i takes channels [0, C),
    frame 2i+1 channels [C, 2C)."""
    b, c2, t, h, w = x.shape
    x = x.reshape(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5)
    return x.reshape(b, c2 // 2, 2 * t, h, w)


class Resample(nn.Module):
    """`upsample2d` / `upsample3d`: nearest 2× in H and W, then a 3×3 conv
    to half the channels; `upsample3d` first doubles the frames after
    frame 0 with a causal time conv.  `downsample2d` / `downsample3d`: one
    zero row and column at the bottom and right, a stride-2 3×3 conv;
    `downsample3d` then halves the frames after frame 0 with a stride-2
    time conv over windows starting at frame 0 (a single frame passes)."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        self.mode = mode
        up = mode.startswith("up")
        self.conv = Conv2dFrames(dim, dim // 2, 3, 1) if up else \
            Conv2dFrames(dim, dim, 3, 0, stride=2)
        if mode == "upsample3d":
            self.time_conv = CausalConv3d(dim, 2 * dim, (3, 1, 1), (1, 0, 0))
        elif mode == "downsample3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), (0, 0, 0),
                                          stride=(2, 1, 1))
        else:
            self.time_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode.startswith("down"):
            x = self.conv(F.pad(x, (0, 1, 0, 1)))
            if self.time_conv is None:
                return x
            if x.shape[2] < 3:
                return x[:, :, :1]
            return torch.cat([x[:, :, :1], self.time_conv(x)], dim=2)
        if self.time_conv is not None and x.shape[2] > 1:
            tail = _interleave_time(self.time_conv(x[:, :, 1:]))
            x = torch.cat([x[:, :, :1], tail], dim=2)
        x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        return self.conv(x)


class UpBlock(nn.Module):
    def __init__(self, ci: int, co: int, num_res_blocks: int,
                 mode: str | None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResidualBlock(ci if j == 0 else co, co)
             for j in range(num_res_blocks + 1)])
        self.upsamplers = nn.ModuleList(
            [] if mode is None else [Resample(co, mode)])

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        for blk in self.resnets:
            x = _maybe_recompute(blk, x, remat)
        for up in self.upsamplers:
            x = up(x)
        return x


class WanDecoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = cfg.dec_dims
        self.conv_in = CausalConv3d(cfg.z_dim, dims[0])
        self.mid_block = MidBlock(dims[0])
        blocks = []
        for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0:
                ci //= 2
            mode = None
            if i != len(cfg.dim_mult) - 1:
                mode = "upsample3d" if cfg.temperal_upsample[i] \
                    else "upsample2d"
            blocks.append(UpBlock(ci, co, cfg.num_res_blocks, mode))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = RMSNorm(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], 3)

    def forward(self, z: torch.Tensor, remat: bool = False) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z), remat)
        for blk in self.up_blocks:
            x = blk(x, remat)
        # the tail runs at the finest resolution: recomputed with remat, so
        # its norm and SiLU outputs are not held through the backward
        return recompute(_decoder_tail, self, x) if remat \
            else _decoder_tail(self, x)


def _decoder_tail(dec: "WanDecoder3d", x: torch.Tensor) -> torch.Tensor:
    x = dec.conv_out(F.silu(dec.norm_out(x)))
    return torch.clamp(x, -1.0, 1.0)


def encoder_plan(cfg: WanVAEConfig) -> list[tuple[str, int, int]]:
    """The flat `down_blocks` list, as the JAX `_encoder_plan`: per stage
    `num_res_blocks` residual blocks, then a resample (but after the last)."""
    dims = cfg.enc_dims
    plan = []
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", ci, co))
            ci = co
        if i != len(cfg.dim_mult) - 1:
            plan.append(("downsample3d" if cfg.temperal_downsample[i]
                         else "downsample2d", co, co))
    return plan


class WanEncoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = cfg.enc_dims
        self.conv_in = CausalConv3d(3, dims[0])
        self.down_blocks = nn.ModuleList(
            ResidualBlock(ci, co) if kind == "res" else Resample(co, kind)
            for kind, ci, co in encoder_plan(cfg))
        self.mid_block = MidBlock(dims[-1])
        self.norm_out = RMSNorm(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], 2 * cfg.z_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) → (B, 2·z, 1 + (T−1)/4, H/8, W/8)."""
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class WanVAEEncoder(nn.Module):
    """`encoder` and `quant_conv`, as in the JAX params tree."""

    def __init__(self, cfg: WanVAEConfig = WanVAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = WanEncoder3d(cfg)
        self.quant_conv = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim,
                                       (1, 1, 1), (0, 0, 0))


def init_encoder(cfg: WanVAEConfig, generator: torch.Generator,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32) -> WanVAEEncoder:
    """An encoder with random weights of the full shapes (see
    `init_decoder`)."""
    return build_random(lambda: WanVAEEncoder(cfg), generator, device, dtype)


@torch.no_grad()
def encode(model: WanVAEEncoder, video: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """video (B, 3, T, H, W) in [−1, 1] → (mu, logvar), each (B, z,
    1 + (T−1)/4, H/8, W/8), in video's dtype.  T must be 1 + 4k: the
    reference's chunked encode silently drops frames beyond that, the JAX
    package and the port refuse.  No grad: the VAE is frozen (the latents
    are plain tensors, which the student's backward may save)."""
    t = video.shape[2]
    if t % 4 != 1:
        raise ValueError(f"the Wan VAE needs T ≡ 1 (mod 4) frames, got {t}")
    h = model.quant_conv(model.encoder(video))
    mu, logvar = h.chunk(2, dim=1)
    return mu, logvar


def sample_posterior(mu: torch.Tensor, logvar: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """`DiagonalGaussianDistribution.sample`: logvar clamped to [−30, 20],
    mu + exp(logvar / 2)·ε with ε drawn from `generator` (on mu's device)."""
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return mu + std * eps


class WanVAEDecoder(nn.Module):
    """`post_quant_conv` and `decoder`, as in the JAX params tree."""

    def __init__(self, cfg: WanVAEConfig = WanVAEConfig()):
        super().__init__()
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, (1, 1, 1),
                                            (0, 0, 0))
        self.decoder = WanDecoder3d(cfg)


def init_decoder(cfg: WanVAEConfig, generator: torch.Generator,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32) -> WanVAEDecoder:
    """A decoder with random weights of the full shapes, drawn from the JAX
    `init` distributions, in `dtype`, with `generator` (which must live on
    `device`)."""
    return build_random(lambda: WanVAEDecoder(cfg), generator, device, dtype)


def decode(model: WanVAEDecoder, z: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """z (B, z_dim, T', h, w), un-normalised → video (B, 3, 1+(T'−1)·4,
    8h, 8w) in [−1, 1], in z's dtype.  remat=False is the inference entry,
    run in inference mode; remat=True the training entry, differentiable in
    z in the caller's grad mode, each residual block, the mid block's
    attention and the tail recomputed in the backward."""
    if not remat:
        with torch.inference_mode():
            return model.decoder(model.post_quant_conv(z))
    return model.decoder(model.post_quant_conv(z), True)


def normalize_latents(z: torch.Tensor) -> torch.Tensor:
    """The VAE's latent z → pipeline space (z − mean) / std."""
    mean = z.new_tensor(LATENTS_MEAN).reshape(1, -1, 1, 1, 1)
    std = z.new_tensor(LATENTS_STD).reshape(1, -1, 1, 1, 1)
    return (z - mean) / std


def unnormalize_latents(z_norm: torch.Tensor) -> torch.Tensor:
    """Pipeline-space z_norm → the VAE's latent z = z_norm·std + mean."""
    mean = z_norm.new_tensor(LATENTS_MEAN).reshape(1, -1, 1, 1, 1)
    std = z_norm.new_tensor(LATENTS_STD).reshape(1, -1, 1, 1, 1)
    return z_norm * std + mean
