"""CogVideoX text-to-video diffusion transformer (the "expert transformer").

diffusers `CogVideoXTransformer3DModel` as CogVideoX-5B's
`transformer/config.json` describes it (arXiv:2408.06072); x are the video
tokens, e the text tokens, c the timestep vector:
  * time: c = Linear(512→512)(SiLU(Linear(D→512)(sinusoid(t)))), the
    sinusoid of width D [cos | sin] (`flip_sin_to_cos`, shift 0);
  * patchify: a Conv2d(16→D, k = s = 2, bias) on each latent frame, tokens
    in (frame, h, w) order; e = Linear(4096→D)(T5's output); no positional
    embedding (RoPE only);
  * each block, on the joint sequence [e; x] (text first): a LayerNorm L
    (affine, eps 1e-5, one for both modalities) and the expert adaptive
    modulation M = Linear(512→6D)(SiLU(c)), split into shift, scale, gate
    for the video and shift, scale, gate for the text; the modulated
    L(·)(1 + scale) + shift of each modality goes into one self-attention
    (biased q, k, v; a per-head LayerNorm on q and k, affine, eps 1e-6;
    the 3D RoPE on the video positions only; scale head_dim^-½; no mask;
    biased output), whose output each modality adds gated by its own
    gate; then the FFN sub-layer, its own L′ and M′ the same way, the FFN
    Linear(D→4D), tanh-GELU, Linear(4D→D) over the joint sequence;
  * 3D RoPE: head_dim split (t, h, w) = (d/4, 3d/8, 3d/8), θ = 10000,
    positions 0..n−1 on each axis (diffusers' crop-region positions at the
    published 60×90 latent), a rotation of consecutive (even, odd) pairs
    (`apply_rotary_emb(use_real_unbind_dim=-1)`, `wan_dit.apply_rope`'s
    convention), the angles in float64 (diffusers: float32);
  * head: LayerNorm on the video tokens, then AdaLayerNorm (shift, scale =
    Linear(512→2D)(SiLU(c)), in that order, over its own LayerNorm),
    Linear(D→16·2·2), unpatchify to the channel-first latent.

The port keeps the joint sequence as one (B, L + N, D) tensor for the
whole forward and modulates and gates each modality's slice of it, so
nothing is split or joined again per block.  Its rounding points are the
Wan DiT's (`nn/wan_dit.py`): the condition (time embedding, every
modulation) is computed in fp32; each LayerNorm and modulation in fp32,
rounded once to the activation dtype; each residual gated in fp32 and
rounded once; a linear layer's product and bias rounded once (cuBLAS's
epilogue).  diffusers rounds at every op in bf16.  The attention goes
through the dispatch (`ops/attention.dot_product_attention`): on the card
the bf16 head_dim-64 flash kernel, one launch a block, counted in
`launches_unmasked`.

The latent is channel-first (B, 16, T, H, W), as the pipeline keeps it,
and cast to the weights' dtype inside the forward; diffusers' (B, T, C, H,
W) is the same data permuted at the boundary.
Parameters keep diffusers' names, but for `attn1.to_out` and `ff.proj`,
`ff.out` (diffusers: `to_out.0`, `ff.net.0.proj`, `ff.net.2`).

`forward` is the inference entry (no gradient path), a span
`cogvideox.forward` (`core/profiling.span`) closed before the module's
forward hooks run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vist3a_tpu_torch.core.profiling import span
from vist3a_tpu_torch.nn.layers import layer_norm
from vist3a_tpu_torch.nn.wan_dit import apply_rope, timestep_embedding
from vist3a_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    num_layers: int = 42
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    ffn_dim: int = 12288
    in_channels: int = 16
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    patch_size: int = 2
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


# THUDM/CogVideoX-5b `transformer/config.json`
COGVIDEOX_5B = CogVideoXConfig()


class PatchEmbed(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.inner_dim, p, stride=p)
        self.text_proj = nn.Linear(cfg.text_embed_dim, cfg.inner_dim)


class TimeEmbedding(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.linear_1 = nn.Linear(cfg.inner_dim, cfg.time_embed_dim)
        self.linear_2 = nn.Linear(cfg.time_embed_dim, cfg.time_embed_dim)


class LayerNormZero(nn.Module):
    """The expert adaptive LayerNorm: one modulation of 6 chunks and one
    LayerNorm for both modalities."""

    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.linear = nn.Linear(cfg.time_embed_dim, 6 * cfg.inner_dim)
        self.norm = nn.LayerNorm(cfg.inner_dim, eps=cfg.norm_eps)


class JointAttention(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        d, dh = cfg.inner_dim, cfg.attention_head_dim
        self.to_q = nn.Linear(d, d)
        self.to_k = nn.Linear(d, d)
        self.to_v = nn.Linear(d, d)
        self.norm_q = nn.LayerNorm(dh, eps=cfg.qk_norm_eps)
        self.norm_k = nn.LayerNorm(dh, eps=cfg.qk_norm_eps)
        self.to_out = nn.Linear(d, d)


class FeedForward(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.proj = nn.Linear(cfg.inner_dim, cfg.ffn_dim)
        self.out = nn.Linear(cfg.ffn_dim, cfg.inner_dim)


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.norm1 = LayerNormZero(cfg)
        self.attn1 = JointAttention(cfg)
        self.norm2 = LayerNormZero(cfg)
        self.ff = FeedForward(cfg)


class AdaLayerNorm(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.linear = nn.Linear(cfg.time_embed_dim, 2 * cfg.inner_dim)
        self.norm = nn.LayerNorm(cfg.inner_dim, eps=cfg.norm_eps)


class CogVideoXDiT(nn.Module):
    def __init__(self, cfg: CogVideoXConfig = COGVIDEOX_5B):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.time_embedding = TimeEmbedding(cfg)
        self.transformer_blocks = nn.ModuleList(
            [CogVideoXBlock(cfg) for _ in range(cfg.num_layers)])
        self.norm_final = nn.LayerNorm(cfg.inner_dim, eps=cfg.norm_eps)
        self.norm_out = AdaLayerNorm(cfg)
        self.proj_out = nn.Linear(
            cfg.inner_dim, cfg.out_channels * cfg.patch_size ** 2)
        self._rope: dict = {}

    def init_params(self, generator: torch.Generator) -> None:
        """Weights normal · fan_in^−½, biases 0, LayerNorm scales 1."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                nn.init.zeros_(p)
            elif p.ndim == 1:
                nn.init.ones_(p)
            else:
                nn.init.normal_(p, std=float(np.prod(p.shape[1:])) ** -0.5,
                                generator=generator)

    def rope(self, grid: tuple, device: torch.device) -> tuple:
        """The RoPE tables of `grid`, built on the host once per grid and
        device."""
        key = (grid, str(device))
        if key not in self._rope:
            self._rope[key] = tuple(
                t.to(device) for t in rope_tables(self.cfg, *grid))
        return self._rope[key]

    def forward(self, latent: torch.Tensor, timestep: torch.Tensor,
                text_embeds: torch.Tensor) -> torch.Tensor:
        with span("cogvideox.forward"):
            return _forward(self, latent, timestep, text_embeds)


def init(cfg: CogVideoXConfig, generator: torch.Generator,
         device: torch.device | str = "cuda",
         dtype: torch.dtype = torch.float32) -> CogVideoXDiT:
    """A DiT with random weights (`CogVideoXDiT.init_params`) drawn in
    `dtype` on `device` with `generator` (which must live there)."""
    with torch.device("meta"):
        model = CogVideoXDiT(cfg)
    model = model.to(dtype).to_empty(device=device)
    with torch.no_grad():
        model.init_params(generator)
    return model.eval().requires_grad_(False)


def rope_tables(cfg: CogVideoXConfig, grid_t: int, grid_h: int, grid_w: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) fp32 (N, head_dim/2) of the pairs, N = t·h·w in (t, h, w)
    row-major order; angles in float64."""
    d = cfg.attention_head_dim
    pairs = (d // 4 // 2, d // 8 * 3 // 2, d // 8 * 3 // 2)   # (t, h, w)

    def axis(n_pos, n_pairs):
        inv = cfg.rope_theta ** (-np.arange(n_pairs, dtype=np.float64)
                                 / n_pairs)
        return np.outer(np.arange(n_pos, dtype=np.float64), inv)

    shape = (grid_t, grid_h, grid_w)
    ang = np.concatenate([
        np.broadcast_to(axis(grid_t, pairs[0])[:, None, None], (*shape,
                                                                pairs[0])),
        np.broadcast_to(axis(grid_h, pairs[1])[None, :, None], (*shape,
                                                                pairs[1])),
        np.broadcast_to(axis(grid_w, pairs[2])[None, None, :], (*shape,
                                                                pairs[2])),
    ], axis=-1).reshape(grid_t * grid_h * grid_w, d // 2)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)),
            torch.from_numpy(np.sin(ang).astype(np.float32)))


def _f32(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A linear layer of the condition, in fp32."""
    return F.linear(x.float(), lin.weight.float(), lin.bias.float())


def _chunks(m: torch.Tensor, n: int) -> tuple:
    """A modulation (B, n·D) → n chunks (B, 1, D)."""
    return tuple(c[:, None] for c in m.chunk(n, -1))


def _modulate(h: torch.Tensor, norm: nn.LayerNorm, mods: tuple, n_text: int
              ) -> torch.Tensor:
    """LN(h)(1 + scale) + shift with each modality's own (shift, scale),
    in fp32, rounded once to h's dtype.  mods: the six (B, 1, D) chunks."""
    y = F.layer_norm(h.float(), (h.shape[-1],), norm.weight.float(),
                     norm.bias.float(), norm.eps)
    sh_v, sc_v, _, sh_t, sc_t, _ = mods
    y[:, :n_text].mul_(1 + sc_t).add_(sh_t)
    y[:, n_text:].mul_(1 + sc_v).add_(sh_v)
    return y.to(h.dtype)


def _gated_residual(h: torch.Tensor, out: torch.Tensor, mods: tuple,
                    n_text: int) -> None:
    """h += gate·out, each modality with its own gate, in fp32, in place."""
    for sl, gate in ((slice(None, n_text), mods[5]),
                     (slice(n_text, None), mods[2])):
        h[:, sl] = (h[:, sl].float() + out[:, sl].float() * gate).to(h.dtype)


def attention(attn: JointAttention, y: torch.Tensor, n_text: int,
              rope: tuple, cfg: CogVideoXConfig) -> torch.Tensor:
    """Self-attention over the joint sequence y (B, L + N, D): per-head
    q/k LayerNorm, RoPE on the video positions (L onward) only."""
    b, n, _ = y.shape
    heads = (b, n, cfg.num_attention_heads, cfg.attention_head_dim)
    q = attn.to_q(y).view(heads)
    k = attn.to_k(y).view(heads)
    v = attn.to_v(y).view(heads)
    eps = cfg.qk_norm_eps
    q = layer_norm(q, attn.norm_q.weight, attn.norm_q.bias, eps)
    k = layer_norm(k, attn.norm_k.weight, attn.norm_k.bias, eps)
    q[:, n_text:] = apply_rope(q[:, n_text:], *rope)
    k[:, n_text:] = apply_rope(k[:, n_text:], *rope)
    out = dot_product_attention(q, k, v)
    return attn.to_out(out.reshape(b, n, -1))


def block_forward(blk: CogVideoXBlock, h: torch.Tensor, cond: torch.Tensor,
                  n_text: int, rope: tuple, cfg: CogVideoXConfig
                  ) -> torch.Tensor:
    """One block on the joint sequence h (B, L + N, D), updated in place;
    cond = SiLU(c) (B, 512) fp32."""
    mods = _chunks(_f32(blk.norm1.linear, cond), 6)
    y = _modulate(h, blk.norm1.norm, mods, n_text)
    _gated_residual(h, attention(blk.attn1, y, n_text, rope, cfg), mods,
                    n_text)
    mods = _chunks(_f32(blk.norm2.linear, cond), 6)
    y = _modulate(h, blk.norm2.norm, mods, n_text)
    ff = blk.ff.out(F.gelu(blk.ff.proj(y), approximate="tanh"))
    _gated_residual(h, ff, mods, n_text)
    return h


def forward(model: CogVideoXDiT, latent: torch.Tensor,
            timestep: torch.Tensor, text_embeds: torch.Tensor
            ) -> torch.Tensor:
    """latent (B, 16, T, H, W), any float dtype (the sampler's fp32 state),
    and text_embeds (B, L, 4096) cast to the weights' dtype inside the
    forward; timestep (B,) float (0..999).  Returns the predicted v
    (B, 16, T, H, W) in the weights' dtype, in inference mode.  The model
    is called as a module, so that its forward hooks run (and see the
    latent as the sampler holds it)."""
    with torch.inference_mode():
        return model(latent, timestep, text_embeds)


def _forward(model, latent, timestep, text_embeds):
    cfg = model.cfg
    b, _, t, hh, ww = latent.shape
    p = cfg.patch_size
    grid = (t, hh // p, ww // p)
    dtype = model.proj_out.weight.dtype
    pe = model.patch_embed

    x = F.conv3d(latent.to(dtype), pe.proj.weight[:, :, None], pe.proj.bias,
                 stride=(1, p, p))
    x = x.flatten(2).transpose(1, 2)                   # (B, N, D)
    e = pe.text_proj(text_embeds.to(dtype))   # (B, L, D)
    n_text = e.shape[1]
    h = torch.cat([e, x], dim=1)                       # the joint sequence

    te = timestep_embedding(timestep, cfg.inner_dim)
    c = _f32(model.time_embedding.linear_2,
             F.silu(_f32(model.time_embedding.linear_1, te)))
    cond = F.silu(c)

    rope = model.rope(grid, h.device)
    for blk in model.transformer_blocks:
        h = block_forward(blk, h, cond, n_text, rope, cfg)

    x = F.layer_norm(h[:, n_text:].float(), (cfg.inner_dim,),
                     model.norm_final.weight.float(),
                     model.norm_final.bias.float(), cfg.norm_eps)
    shift, scale = _chunks(_f32(model.norm_out.linear, cond), 2)
    norm = model.norm_out.norm
    x = F.layer_norm(x, (cfg.inner_dim,), norm.weight.float(),
                     norm.bias.float(), cfg.norm_eps)
    x = (x * (1 + scale) + shift).to(dtype)
    x = model.proj_out(x)                     # (B, N, C·p·p)
    x = x.reshape(b, *grid, cfg.out_channels, p, p)
    x = x.permute(0, 4, 1, 2, 5, 3, 6)                 # B, C, t, gh, p, gw, p
    return x.reshape(b, cfg.out_channels, t, hh, ww)
