"""DINOv2 vision transformer: the chopped half and the whole trunk.

Port of `vist3a_tpu/nn/vit.py`: `ViTConfig`, `VIT_LARGE` (ViT-L/14, 4
register tokens, LayerScale 1.0, LN eps 1e-6, no QK-norm),
`interpolate_pos_embed`, `patch_embed`, `prepare_tokens` and
`forward_features`.  The stitched decoder replaces the patch embedding and
the first `stitch_layer_index` blocks with the stitch conv, so `ChoppedViT`
holds only the special tokens, the positional embedding, the blocks after
the chop and the final norm.  `ViT`, the distillation teacher's trunk, adds
the 14×14 patch embedding and holds blocks [0, depth); both run the same
token assembly (`prepare_tokens`) and blocks (`blocks_and_norm`).  Blocks
sit in a `ModuleDict` keyed by their index in the full trunk, so a state
dict names them as the JAX stack does.  The JAX trunk's `mask_token` (for
masked-image pretraining) is read by no forward here and is not held.

`interpolate_pos_embed` reproduces `jax.image.resize(method="bicubic",
antialias=True)` as two (out, in) weight matrices built in numpy by the rule
of `jax.image.scale_and_translate`: Keys cubic (a = −0.5), the kernel
widened by 1/scale when downsampling, weights normalised per output sample.
`F.interpolate(mode="bicubic", antialias=True)` differs from it in kernel
support, normalisation and edges.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vist3a_tpu_torch.nn.layers import (Block, BlockConfig, LayerNorm,
                                        run_blocks)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    layerscale: float = 1.0
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    def block_config(self) -> BlockConfig:
        return BlockConfig(dim=self.embed_dim, num_heads=self.num_heads,
                           mlp_ratio=self.mlp_ratio, qk_norm=False,
                           ln_eps=self.ln_eps, layerscale=self.layerscale,
                           use_rope=False)


VIT_LARGE = ViTConfig()  # dinov2_vitl14_reg — the VGGT-1B trunk


class ChoppedViT(nn.Module):
    """Blocks [start, depth) of the trunk plus tokens, pos-embed and norm."""

    def __init__(self, cfg: ViTConfig, start: int):
        super().__init__()
        d = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.register_tokens = nn.Parameter(
            torch.empty(1, cfg.num_register_tokens, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, d))
        self.blocks = nn.ModuleDict(
            {str(i): Block(cfg.block_config()) for i in range(start, cfg.depth)})
        self.norm = LayerNorm(d, cfg.ln_eps)

    def init_params(self, generator: torch.Generator) -> None:
        for p, std in ((self.cls_token, 1e-6), (self.register_tokens, 1e-6),
                       (self.pos_embed, 0.02)):
            nn.init.normal_(p, std=std, generator=generator)


class PatchEmbed(nn.Conv2d):
    """The p×p stride-p patch projection, weight (D, 3, p, p) as in the JAX
    tree; N(0, 0.02²) weights and zero bias at init, as there."""

    def __init__(self, cfg: ViTConfig):
        super().__init__(3, cfg.embed_dim, cfg.patch_size,
                         stride=cfg.patch_size)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=0.02, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) → patch tokens (B, H/p·W/p, D), row-major, in the
        images' dtype; the bias is added after the product, as in JAX."""
        out = F.conv2d(images, self.weight.to(images.dtype),
                       stride=self.stride)
        out = out + self.bias.to(out.dtype)[None, :, None, None]
        return out.flatten(2).transpose(1, 2)


class ViT(ChoppedViT):
    """The whole trunk: the patch embedding and blocks [0, depth)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__(cfg, 0)
        self.patch_proj = PatchEmbed(cfg)


def prepare_tokens(vit: ChoppedViT, patch_tokens: torch.Tensor,
                   grid_hw: tuple[int, int], cfg: ViTConfig) -> torch.Tensor:
    """Patch tokens (N, gh·gw, D) → [cls, registers, patches] in their
    dtype, the interpolated positional embedding added to cls and patches
    before the registers go in (they carry none)."""
    n, _, d = patch_tokens.shape
    x = torch.cat([vit.cls_token.to(patch_tokens.dtype).expand(n, 1, d),
                   patch_tokens], dim=1)
    x = x + interpolate_pos_embed(vit.pos_embed, *grid_hw).to(x.dtype)
    reg = vit.register_tokens.to(x.dtype).expand(n, cfg.num_register_tokens,
                                                 d)
    return torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)


def blocks_and_norm(vit: ChoppedViT, x: torch.Tensor, cfg: ViTConfig, *,
                    remat: bool = False) -> torch.Tensor:
    """The held blocks (each recomputed in the backward with remat), the
    final norm, and the special tokens stripped: normalised patch tokens."""
    x = run_blocks(vit.blocks.values(), x, remat_blocks=remat)
    return vit.norm(x)[:, 1 + cfg.num_register_tokens:]


def forward_features(vit: ViT, images: torch.Tensor, cfg: ViTConfig, *,
                     remat: bool = False) -> torch.Tensor:
    """Images (N, 3, H, W) → normalised patch tokens (N, H/p·W/p, D) in the
    trunk's dtype: the patch embedding and token assembly in the images'
    dtype, then the blocks in their parameters'."""
    grid_hw = (images.shape[-2] // cfg.patch_size,
               images.shape[-1] // cfg.patch_size)
    x = prepare_tokens(vit, vit.patch_proj(images), grid_hw, cfg)
    return blocks_and_norm(vit, x.to(vit.cls_token.dtype), cfg, remat=remat)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=16)
def bicubic_antialias_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of `jax.image.resize(..., "bicubic",
    antialias=True)` along one axis (scale n_out/n_in, no translation)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    return np.ascontiguousarray(w.T).astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_h: int,
                          grid_w: int) -> torch.Tensor:
    """(1, 1+M², D) → (1, 1+grid_h·grid_w, D); bicubic antialias resize of
    the patch part in fp32, cast back to the input dtype."""
    n = pos_embed.shape[1] - 1
    m = int(round(n ** 0.5))
    if (grid_h, grid_w) == (m, m):
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed[0, 1:].float().reshape(m, m, d)
    wh = torch.from_numpy(bicubic_antialias_matrix(m, grid_h)).to(grid.device)
    ww = torch.from_numpy(bicubic_antialias_matrix(m, grid_w)).to(grid.device)
    grid = torch.einsum("oh,hwd->owd", wh, grid)
    grid = torch.einsum("pw,owd->opd", ww, grid)
    out = torch.cat([pos_embed[:, :1].float(),
                     grid.reshape(1, grid_h * grid_w, d)], dim=1)
    return out.to(pos_embed.dtype)
