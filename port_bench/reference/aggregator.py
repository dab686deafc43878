"""The plain reference's VGGT aggregator: the alternating frame/global
attention trunk (frozen from the port's `nn/aggregator.py`; see
`reference/scene.py`; it imports nothing of the port).

Dual camera/register special tokens (slot 0 for the first frame, slot 1
for the rest), 24 layer pairs of frame attention over (B·S, P, C) and
global attention over (B, S·P, C), blocks with QK-norm, LayerScale 0.01
and 2-D RoPE (frequency 100, special tokens at (0, 0)), and taps
concat(frame_out, global_out) at layers {4, 11, 17, 23}.  P is padded to a
multiple of 16, the RoPE tables padded with cos 1 and sin 0, the pad tokens
masked as attention keys (tiled over the S frames for global attention),
and the taps and final tokens unpadded afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers import Block, BlockConfig
from port_bench.reference.rope import grid_positions, rope2d_cos_sin

NUM_SPECIAL = 5  # 1 camera + 4 register tokens
DEFAULT_TAPS = (4, 11, 17, 23)
TOKEN_ALIGN = 16


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    patch_size: int = 14
    rope_freq: float = 100.0
    taps: Sequence[int] = DEFAULT_TAPS

    def block_config(self) -> BlockConfig:
        return BlockConfig(dim=self.embed_dim, num_heads=self.num_heads,
                           mlp_ratio=self.mlp_ratio, qk_norm=True,
                           ln_eps=1e-5, layerscale=0.01,
                           use_rope=self.rope_freq > 0)

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens


class Aggregator(nn.Module):
    def __init__(self, cfg: AggregatorConfig):
        super().__init__()
        d = cfg.embed_dim
        self.camera_token = nn.Parameter(torch.empty(1, 2, 1, d))
        self.register_token = nn.Parameter(
            torch.empty(1, 2, cfg.num_register_tokens, d))
        self.frame_blocks = nn.ModuleList(
            Block(cfg.block_config()) for _ in range(cfg.depth))
        self.global_blocks = nn.ModuleList(
            Block(cfg.block_config()) for _ in range(cfg.depth))

def expand_special_tokens(tok: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(1, 2, X, C): slot 0 → first frame, slot 1 → the other S−1 frames;
    returns (B·S, X, C)."""
    first = tok[:, 0:1].expand(b, 1, *tok.shape[2:])
    rest = tok[:, 1:2].expand(b, s - 1, *tok.shape[2:])
    return torch.cat([first, rest], dim=1).reshape(b * s, *tok.shape[2:])


def rope_tables(cfg: AggregatorConfig, grid_h: int, grid_w: int,
                n_frames: int, device: torch.device | str = "cuda"):
    """Fused cos/sin for frame (P tokens) and global (S·P) attention."""
    head_dim = cfg.embed_dim // cfg.num_heads
    pos = grid_positions(grid_h, grid_w, special=cfg.patch_start_idx)
    cos, sin = rope2d_cos_sin(pos, head_dim, cfg.rope_freq, device=device)
    return (cos, sin), (cos.repeat(n_frames, 1), sin.repeat(n_frames, 1))


def _layer_pair(frame_blk: Block, global_blk: Block, tokens, rope_f, rope_g,
                kv_f=None, kv_g=None):
    """One frame-attention + global-attention pair over (B, S, P, C)."""
    b, s, p, c = tokens.shape
    x = frame_blk(tokens.reshape(b * s, p, c), *rope_f, key_valid=kv_f)
    frame_out = x.reshape(b, s, p, c)
    xg = global_blk(frame_out.reshape(b, s * p, c), *rope_g, key_valid=kv_g)
    return xg.reshape(b, s, p, c), frame_out


def run_trunk(agg: Aggregator, tokens: torch.Tensor, cfg: AggregatorConfig,
              grid_hw: tuple[int, int]):
    """Layers [0, depth) over (B, S, P, C) tokens, padded as the module's
    docstring says.

    Returns (final_tokens, taps): taps are (B, S, P, 2C) at each tap layer,
    in layer order.  The trunk computes in its parameters' dtype (bf16
    deployed), whatever dtype the tokens arrive in."""
    tokens = tokens.to(agg.camera_token.dtype)
    b, s, p, c = tokens.shape
    (cos_f, sin_f), _ = rope_tables(cfg, *grid_hw, n_frames=s,
                                    device=tokens.device)
    p_real, kv_f, kv_g = p, None, None
    pad = (-p) % TOKEN_ALIGN
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
        p += pad
        cos_f = F.pad(cos_f, (0, 0, 0, pad), value=1.0)
        sin_f = F.pad(sin_f, (0, 0, 0, pad))
        kv_f = torch.arange(p, device=tokens.device) < p_real
        kv_g = kv_f.repeat(s)
    rope_f = (cos_f, sin_f)
    rope_g = (cos_f.repeat(s, 1), sin_f.repeat(s, 1))

    tap_layers = set(cfg.taps)
    taps = []
    for i in range(cfg.depth):
        tokens, frame_out = _layer_pair(agg.frame_blocks[i],
                                        agg.global_blocks[i], tokens,
                                        rope_f, rope_g, kv_f, kv_g)
        if i in tap_layers:
            taps.append(torch.cat([frame_out, tokens], dim=-1)[:, :, :p_real])
    return tokens[:, :, :p_real], taps


def special_tokens(agg: Aggregator, patch_tokens: torch.Tensor, b: int,
                   s: int) -> torch.Tensor:
    """Patch tokens (B·S, P', C) → (B, S, 5 + P', C) with the camera and
    register tokens in front, in the patch tokens' dtype."""
    cam = expand_special_tokens(agg.camera_token.to(patch_tokens.dtype), b, s)
    reg = expand_special_tokens(agg.register_token.to(patch_tokens.dtype),
                                b, s)
    tokens = torch.cat([cam, reg, patch_tokens], dim=1)
    return tokens.reshape(b, s, tokens.shape[1], -1)


