"""2-D rotary position embeddings for the VGGT aggregator.

Port of `vist3a_tpu/ops/rope.py`: head_dim D splits in half, the first half
rotates by the y coordinate and the second by x, each with 1-D RoPE of base
frequency 100 over D/2 channels (duplicated-angle, rotate-half layout).
Special (camera/register) tokens sit at (0, 0), patch positions start at 1.
The fused per-token cos/sin tables are built once per grid shape in numpy
(fp64) and shared by every block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def grid_positions(height: int, width: int, special: int = 0) -> np.ndarray:
    """(P, 2) int32 y,x positions for an h×w patch grid, preceded by
    ``special`` tokens at (0,0); grid positions start at 1 when special>0."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pos = np.stack([ys.reshape(-1), xs.reshape(-1)], axis=-1).astype(np.int32)
    if special:
        pos = np.concatenate(
            [np.zeros((special, 2), np.int32), pos + 1], axis=0)
    return pos


@functools.lru_cache(maxsize=32)
def _tables(max_pos: int, half_dim: int, base: float
            ) -> tuple[np.ndarray, np.ndarray]:
    exponents = np.arange(0, half_dim, 2, dtype=np.float64) / half_dim
    inv_freq = 1.0 / (base ** exponents)
    angles = np.arange(max_pos, dtype=np.float64)[:, None] * inv_freq[None, :]
    angles = np.concatenate([angles, angles], axis=-1)   # (max_pos, half_dim)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def rope2d_cos_sin(positions: np.ndarray, head_dim: int, base: float = 100.0,
                   device: torch.device | str = "cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (P, head_dim) fp32: first half y, second half x."""
    half = head_dim // 2
    cos_t, sin_t = _tables(int(positions.max()) + 1, half, base)
    y, x = positions[:, 0], positions[:, 1]
    cos = np.concatenate([cos_t[y], cos_t[x]], axis=-1)
    sin = np.concatenate([sin_t[y], sin_t[x]], axis=-1)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate_half(h: torch.Tensor) -> torch.Tensor:
    h1, h2 = h.chunk(2, dim=-1)
    return torch.cat([-h2, h1], dim=-1)


def apply_rope2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x: (..., P, head_dim); cos/sin: (P, head_dim) broadcast over the lead
    dims.  Per half h = [h1, h2]: out = h·cos + [−h2, h1]·sin."""
    hy, hx = x.chunk(2, dim=-1)
    cy, cx = cos.chunk(2, dim=-1)
    sy, sx = sin.chunk(2, dim=-1)
    return torch.cat([hy * cy + _rotate_half(hy) * sy,
                      hx * cx + _rotate_half(hx) * sx], dim=-1)
