"""The plain reference's Wan 2.1 text-to-video diffusion transformer (frozen
from the port's `nn/wan_dit.py`, attention on plain math; see
`reference/scene.py`; it imports nothing of the port).

  * patchify: conv3d k = s = (1, 2, 2), 16 → dim channels;
  * condition embedder in fp32: sinusoidal timestep [cos | sin] → MLP →
    SiLU → Linear(dim, 6·dim), the per-step adaLN vector; text:
    Linear(text_dim, dim) → GELU(tanh) → Linear(dim, dim);
  * N blocks: adaLN over {self-attention with 3D RoPE and a fused QKV,
    text cross-attention after an affine fp32 LayerNorm, GELU(tanh) MLP};
    q/k RMSNorm across the full inner dim;
  * 3D RoPE: head_dim split (t, h, w) = (d − 4⌊d/6⌋, 2⌊d/6⌋, 2⌊d/6⌋),
    θ = 10000, a complex rotation of consecutive (even, odd) pairs, the
    angles in float64 on the host;
  * head: fp32 LayerNorm modulated by a 2-chunk table, linear to 16·1·2·2,
    unpatchify.

Rounding points: a linear layer rounds its product to the activation dtype
and then adds the bias in that dtype; the attn1 and MLP residuals are gated
in fp32 and rounded once; the attn2 residual is added in the activation
dtype.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers import rms_norm
from port_bench.reference.attention import plain_attention


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    dim: int = 1536
    ffn_dim: int = 8960
    num_layers: int = 30
    num_heads: int = 12
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    patch_size: tuple = (1, 2, 2)
    eps: float = 1e-6
    rope_max_seq_len: int = 1024
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_1_3B = WanDiTConfig()


# --------------------------------------------------------------------------- #
# pieces                                                                      #
# --------------------------------------------------------------------------- #
class WanLinear(nn.Module):
    """Weight (out, in) and bias; the product is rounded to x's dtype
    before the bias is added in that dtype."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class WanMLP(nn.Module):
    def __init__(self, d_in: int, hidden: int, d_out: int):
        super().__init__()
        self.fc1 = WanLinear(d_in, hidden)
        self.fc2 = WanLinear(hidden, d_out)


def _fp32_ln(x: torch.Tensor, eps: float, weight: torch.Tensor | None = None,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """LayerNorm in fp32 (diffusers `FP32LayerNorm`); returns fp32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y


def timestep_embedding(t: torch.Tensor, freq_dim: int) -> torch.Tensor:
    """diffusers `Timesteps(freq_dim, flip_sin_to_cos=True, shift=0)`:
    [cos | sin] of t · exp(−ln 1e4 · i/half), fp32."""
    half = freq_dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(cfg: WanDiTConfig, grid_t: int, grid_h: int, grid_w: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) fp32 tables (N, head_dim/2) on the host, N = t·h·w in
    (t, h, w) row-major order; angles in float64, as in the JAX package."""
    d = cfg.head_dim
    h_pairs = w_pairs = d // 6
    t_pairs = d // 2 - h_pairs - w_pairs

    def axis_freqs(n_pos, pairs):
        inv = 1.0 / (cfg.rope_theta
                     ** (np.arange(0, pairs, dtype=np.float64) / pairs))
        return np.outer(np.arange(n_pos, dtype=np.float64), inv)

    shape = (grid_t, grid_h, grid_w)
    ft = axis_freqs(grid_t, t_pairs)
    fh = axis_freqs(grid_h, h_pairs)
    fw = axis_freqs(grid_w, w_pairs)
    ang = np.concatenate([
        np.broadcast_to(ft[:, None, None, :], (*shape, t_pairs)),
        np.broadcast_to(fh[None, :, None, :], (*shape, h_pairs)),
        np.broadcast_to(fw[None, None, :, :], (*shape, w_pairs)),
    ], axis=-1).reshape(grid_t * grid_h * grid_w, d // 2)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)),
            torch.from_numpy(np.sin(ang).astype(np.float32)))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, N, H, D): rotate consecutive (even, odd) pairs in fp32."""
    xf = x.float()
    b, n, h, d = xf.shape
    pair = xf.reshape(b, n, h, d // 2, 2)
    xr, xi = pair[..., 0], pair[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class WanAttention(nn.Module):
    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.q = WanLinear(d, d)
        self.k = WanLinear(d, d)
        self.v = WanLinear(d, d)
        self.o = WanLinear(d, d)
        self.norm_q = nn.Parameter(torch.empty(d))
        self.norm_k = nn.Parameter(torch.empty(d))

def _linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """`WanLinear.forward` with the weights of `p`."""
    return (F.linear(x, p[f"{name}.weight"].to(x.dtype))
            + p[f"{name}.bias"].to(x.dtype))


def attention(p: dict, x: torch.Tensor, context: torch.Tensor | None,
              rope: tuple | None, cfg: WanDiTConfig) -> torch.Tensor:
    """Self-attention (context None: one fused QKV product, RoPE) or
    cross-attention, with the weights of `p` ({"q.weight", ...,
    "norm_q", "norm_k"})."""
    b, n, _ = x.shape
    dh = cfg.head_dim
    d = p["q.weight"].shape[0]
    h = d // dh
    if context is None:
        w = torch.cat([p["q.weight"], p["k.weight"], p["v.weight"]])
        bias = torch.cat([p["q.bias"], p["k.bias"], p["v.bias"]])
        qkv = F.linear(x, w.to(x.dtype)) + bias.to(x.dtype)
        q, k, v = qkv.split(d, dim=-1)
        context_len = n
    else:
        q, k, v = (_linear(p, "q", x), _linear(p, "k", context),
                   _linear(p, "v", context))
        context_len = context.shape[1]
    q = rms_norm(p["norm_q"], q, cfg.eps).reshape(b, n, h, dh)
    k = rms_norm(p["norm_k"], k, cfg.eps).reshape(b, context_len, h, dh)
    v = v.reshape(b, context_len, h, dh)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    out = plain_attention(q, k, v)
    return _linear(p, "o", out.reshape(b, n, d))


class AffineNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

class WanBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.cfg = cfg
        self.scale_shift_table = nn.Parameter(torch.empty(6, cfg.dim))
        self.attn1 = WanAttention(cfg)
        self.attn2 = WanAttention(cfg)
        self.norm2 = AffineNorm(cfg.dim)
        self.ffn = WanMLP(cfg.dim, cfg.ffn_dim, cfg.dim)

def _sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def block_forward(p: dict, x: torch.Tensor, text: torch.Tensor,
                  temb6: torch.Tensor, rope: tuple,
                  cfg: WanDiTConfig) -> torch.Tensor:
    """One block with the weights of `p` (the block's parameter names)."""
    eps = cfg.eps
    mods = p["scale_shift_table"].float()[None] + temb6
    sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (
        mods[:, i][:, None] for i in range(6))
    dtype = x.dtype

    y = (_fp32_ln(x, eps) * (1 + sc_msa) + sh_msa).to(dtype)
    attn = attention(_sub(p, "attn1."), y, None, rope, cfg)
    x = (x.float() + attn.float() * g_msa).to(dtype)

    y = _fp32_ln(x, eps, p["norm2.weight"], p["norm2.bias"]).to(dtype)
    x = x + attention(_sub(p, "attn2."), y, text, None, cfg)

    y = (_fp32_ln(x, eps) * (1 + sc_mlp) + sh_mlp).to(dtype)
    ff = _linear(p, "ffn.fc2", F.gelu(_linear(p, "ffn.fc1", y),
                                      approximate="tanh"))
    return (x.float() + ff.float() * g_mlp).to(dtype)


class PatchEmbedding(nn.Module):
    """conv3d weight (dim, in, pt, ph, pw) and bias."""

    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.dim, cfg.in_channels,
                                               *cfg.patch_size))
        self.bias = nn.Parameter(torch.empty(cfg.dim))

class WanDiT(nn.Module):
    """The parameters of the JAX tree, one module per block."""

    def __init__(self, cfg: WanDiTConfig = WAN_1_3B):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.patch_embedding = PatchEmbedding(cfg)
        self.time_embedder = WanMLP(cfg.freq_dim, d, d)
        self.time_proj = WanLinear(d, 6 * d)
        self.text_embedder = WanMLP(cfg.text_dim, d, d)
        self.blocks = nn.ModuleList([WanBlock(cfg)
                                     for _ in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.empty(2, d))
        self.proj_out = WanLinear(
            d, cfg.out_channels * math.prod(cfg.patch_size))
        self._rope: dict = {}

    def rope(self, grid: tuple, device: torch.device) -> tuple:
        """The RoPE tables of `grid`, built on the host once per grid and
        device."""
        key = (grid, str(device))
        if key not in self._rope:
            self._rope[key] = tuple(
                t.to(device) for t in rope_tables(self.cfg, *grid))
        return self._rope[key]


@torch.inference_mode()
def forward(model: WanDiT, latent: torch.Tensor, timestep: torch.Tensor,
            text_embeds: torch.Tensor) -> torch.Tensor:
    """latent (B, 16, T, H, W) in the activation dtype; timestep (B,) float
    (σ·1000); text_embeds (B, L, text_dim).  Returns the predicted velocity
    (B, 16, T, H, W) in latent's dtype."""
    cfg = model.cfg
    b, _, t, hh, ww = latent.shape
    pt, ph, pw = cfg.patch_size
    grid = (t // pt, hh // ph, ww // pw)
    dtype = latent.dtype

    pe = model.patch_embedding
    x = F.conv3d(latent, pe.weight.to(dtype), stride=cfg.patch_size)
    x = x + pe.bias.to(dtype)[:, None, None, None]
    x = x.flatten(2).transpose(1, 2)                    # (B, N, D)

    # condition embedder, fp32 end to end
    te = timestep_embedding(timestep, cfg.freq_dim)
    temb = model.time_embedder.fc2(F.silu(model.time_embedder.fc1(te)))
    temb6 = model.time_proj(F.silu(temb)).reshape(b, 6, cfg.dim)
    text = model.text_embedder.fc2(F.gelu(
        model.text_embedder.fc1(text_embeds.to(dtype)), approximate="tanh"))

    rope = model.rope(grid, x.device)
    for blk in model.blocks:
        x = block_forward(dict(blk.named_parameters()), x, text, temb6, rope,
                          cfg)

    mods = model.scale_shift_table.float()[None] + temb.float()[:, None]
    shift, scale = mods[:, 0][:, None], mods[:, 1][:, None]
    x = (_fp32_ln(x, cfg.eps) * (1 + scale) + shift).to(dtype)
    x = model.proj_out(x)

    x = x.reshape(b, *grid, pt, ph, pw, cfg.out_channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)              # B,C,gt,pt,gh,ph,gw,pw
    return x.reshape(b, cfg.out_channels, t, hh, ww)
