"""The plain reference's chopped DINOv2 trunk (frozen from the port's
`nn/vit.py`; see `reference/scene.py`; it imports nothing of the port).

ViT-L/14 (`VIT_LARGE`: 4 register tokens, LayerScale 1.0, LN eps 1e-6, no
QK-norm).  The stitched decoder replaces the patch embedding and the first
`stitch_layer_index` blocks with the stitch conv, so `ChoppedViT` holds
only the special tokens, the positional embedding, the blocks after the
chop and the final norm; `prepare_tokens` assembles [cls, registers,
patches] and `blocks_and_norm` runs the blocks.  Blocks sit in a
`ModuleDict` keyed by their index in the full trunk.

`interpolate_pos_embed` is `jax.image.resize(method="bicubic",
antialias=True)` as two (out, in) weight matrices (`resize.resize_matrix`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from port_bench.reference.layers import Block, BlockConfig, LayerNorm
from port_bench.reference.resize import resize_matrix


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


def blocks_and_norm(vit: ChoppedViT, x: torch.Tensor,
                    cfg: ViTConfig) -> torch.Tensor:
    """The held blocks, the final norm, and the special tokens stripped:
    normalised patch tokens."""
    for blk in vit.blocks.values():
        x = blk(x)
    return vit.norm(x)[:, 1 + cfg.num_register_tokens:]


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
    wh = torch.from_numpy(resize_matrix(m, grid_h)).to(grid.device)
    ww = torch.from_numpy(resize_matrix(m, grid_w)).to(grid.device)
    grid = torch.einsum("oh,hwd->owd", wh, grid)
    grid = torch.einsum("pw,owd->opd", ww, grid)
    out = torch.cat([pos_embed[:, :1].float(),
                     grid.reshape(1, grid_h * grid_w, d)], dim=1)
    return out.to(pos_embed.dtype)
