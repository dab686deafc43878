"""The plain reference's transformer building blocks, pre-norm ViT style
(frozen from the port's `nn/layers.py`; see `reference/scene.py`; it
imports nothing of the port).  Each block is its own `nn.Module`, run by a
Python loop.

  * `layer_norm` takes its statistics in fp32 and casts back to the input
    dtype;
  * `linear` casts the weight to the input dtype and accumulates in fp32,
    output in the input dtype;
  * `gelu` is the tanh approximation for bf16 activations and the exact erf
    form otherwise.

Modules are built with uninitialised parameters; the benchmark fills them
from the seed (`common.WeightStream`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.attention import plain_attention
from port_bench.reference.rope import apply_rope2d


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis (UMT5's, and the Wan DiT's q/k norm across
    the full inner dim): statistics and rescale in fp32, cast back to x's
    dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Module):
    """Weight (out, in), the transpose of the JAX package's (in, out) `w`."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim if out is None else out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    dim: int
    num_heads: int
    mlp_ratio: float = 4.0
    qk_norm: bool = False
    ln_eps: float = 1e-5
    layerscale: float | None = None   # None → no LayerScale
    use_rope: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)


class Attention(nn.Module):
    def __init__(self, cfg: BlockConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = Linear(cfg.dim, 3 * cfg.dim)
        self.proj = Linear(cfg.dim, cfg.dim)
        if cfg.qk_norm:
            # per-head-dim LayerNorm at torch's default eps
            self.q_norm = LayerNorm(cfg.head_dim, 1e-5)
            self.k_norm = LayerNorm(cfg.head_dim, 1e-5)

    def forward(self, x, rope_cos=None, rope_sin=None, key_valid=None):
        cfg = self.cfg
        b, n, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, cfg.num_heads,
                                      cfg.head_dim).unbind(2)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if cfg.use_rope and rope_cos is not None:
            # (B, N, H, D): rotate over N, broadcast over heads
            cs = rope_cos.to(q.dtype)[:, None]
            sn = rope_sin.to(q.dtype)[:, None]
            q, k = apply_rope2d(q, cs, sn), apply_rope2d(k, cs, sn)
        o = plain_attention(q, k, v, key_valid=key_valid)
        return self.proj(o.reshape(b, n, cfg.dim))


class Block(nn.Module):
    def __init__(self, cfg: BlockConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(cfg.dim, cfg.ln_eps)
        self.mlp = Mlp(cfg.dim, cfg.hidden)
        if cfg.layerscale is not None:
            self.ls1 = LayerScale(cfg.dim, cfg.layerscale)
            self.ls2 = LayerScale(cfg.dim, cfg.layerscale)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x, rope_cos=None, rope_sin=None, key_valid=None):
        h = self.attn(self.norm1(x), rope_cos, rope_sin, key_valid)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + h


