"""Transformer building blocks (pre-norm ViT style).

Port of `vist3a_tpu/nn/layers.py`.  The JAX package keeps a block stack as
one pytree with a leading layer axis and runs it with `lax.scan`; here each
block is its own `nn.Module` in a `ModuleList`, run by a Python loop.
`recompute` and `run_blocks(remat_blocks=True)` take the place of
`jax.checkpoint` and `scan_blocks(remat=True)` on the training path.

Numerics follow the JAX functions:
  * `layer_norm` takes its statistics in fp32 and casts back to the input
    dtype;
  * `linear` casts the weight to the input dtype and accumulates in fp32
    (PyTorch's bf16 matmuls accumulate in fp32), output in the input dtype;
  * `gelu` is the tanh approximation for bf16 activations and the exact erf
    form otherwise (`nn/layers.py:81-103` of the JAX package gives the
    measurement behind the policy).

Modules are built with uninitialised parameters: weights come from
`convert.load_jax_params` or from `init_params(generator)`, which draws them
from the JAX package's distributions (truncated normal σ 0.02 for linear
weights, zero biases, unit LayerNorm scales, constant LayerScale).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from vist3a_tpu_torch.ops.attention import dot_product_attention
from vist3a_tpu_torch.ops.rope import apply_rope2d


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

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Module):
    """Weight (out, in), the transpose of the JAX package's (in, out) `w`."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.trunc_normal_(self.weight, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.empty(dim))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.gamma, self.init_value)

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
    attn_impl: str = "auto"           # "auto" or "plain" (the JAX "xla")

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
        o = dot_product_attention(q, k, v, impl=cfg.attn_impl,
                                  key_valid=key_valid)
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


class _Bound(nn.Module):
    """`fn(module, *args)` as a module's forward, for `functional_call`."""

    def __init__(self, fn: Callable, module: nn.Module):
        super().__init__()
        self.fn = fn
        self.module = module

    def forward(self, *args):
        return self.fn(self.module, *args)


def recompute(fn: Callable, module: nn.Module, *args):
    """`fn(module, *args)`, its activations recomputed in the backward — the
    counterpart of `jax.checkpoint` (a non-reentrant
    `torch.utils.checkpoint`).  The recompute runs after the forward's
    caller has returned, so it binds, through `functional_call`, the
    parameter tensors `module` holds now: under the trainer's
    `functional_call` those are the merged student weights, gone from the
    module by the time the backward runs.  Without grad mode it is a plain
    call."""
    if not torch.is_grad_enabled():
        return fn(module, *args)
    bound = _Bound(fn, module)
    params = dict(bound.named_parameters())
    return checkpoint(lambda *a: functional_call(bound, params, a), *args,
                      use_reentrant=False)


def run_blocks(blocks, x: torch.Tensor, *, remat_blocks: bool = False,
               **kwargs) -> torch.Tensor:
    """The blocks in order over x; with remat_blocks each block is
    recomputed in the backward (`scan_blocks(remat=True)`)."""
    for blk in blocks:
        x = recompute(lambda b, y: b(y, **kwargs), blk, x) if remat_blocks \
            else blk(x, **kwargs)
    return x


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of `module` from its own module's distribution."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_params"):
                m.init_params(generator)


def build_random(factory: Callable[[], nn.Module], generator: torch.Generator,
                 device: torch.device | str, dtype: torch.dtype) -> nn.Module:
    """`factory()` with random weights drawn by each module's `init_params`
    with `generator` (which must live on `device`), in `dtype`.  The
    parameters are allocated once, on `device` and in `dtype`, never first
    in fp32 or on the host."""
    with torch.device("meta"):
        model = factory()
    model = model.to(dtype).to_empty(device=device)
    init_params(model, generator)
    return model.eval().requires_grad_(False)
