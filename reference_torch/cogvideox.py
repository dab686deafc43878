"""A plain reference of CogVideoX-5B text→latent: the T5 v1.1 encoder, the
CogVideoX DiT and the v-prediction DDIM chain with classifier-free
guidance.

Plain PyTorch in the modules' dtype (float32 for the reference; the
benchmark's control builds it in bf16), following the published models
op for op as HF `T5EncoderModel` and diffusers `CogVideoXTransformer3DModel`,
`CogVideoXDDIMScheduler` and `CogVideoXPipeline` compute them: the text
and the video tokens kept as two streams, joined for the attention and the
FFN and split again, every op rounded to the modules' dtype.  It imports
nothing of the program; its parameters have the program's names and
order, so a stream of weights fills both alike.  Matrix products in
float32 need TF32 off on the card (`torch.backends.cuda.matmul.allow_tf32
= False`), which the caller sets.

Departures from the published code, none of which changes the
mathematics:
  * attention is a plain softmax over blocks of `QUERY_BLOCK` queries
    (diffusers: `F.scaled_dot_product_attention`), so that the (2, 48,
    17,776²) scores of the published size fit in float32;
  * the latent is channel-first (B, 16, T, H, W) at the DiT's boundary
    (diffusers: (B, T, C, H, W)), permuted inside;
  * RoPE positions are 0..n−1 on each axis: diffusers' crop region at the
    published 60×90 latent (its 30×45 base grid); other sizes, which
    diffusers maps onto that base grid, are not served;
  * the final LayerNorm runs on the video tokens alone (diffusers runs it
    on the joint sequence and drops the text: the same per token);
  * parameter names `attn1.to_out`, `ff.proj`, `ff.out` (diffusers:
    `to_out.0`, `ff.net.0.proj`, `ff.net.2`);
  * the DDIM schedule in float64 (diffusers: float32 betas);
  * T5 and the DiT run without dropout (inference).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

QUERY_BLOCK = 1024
# CogVideoXPipeline with VIST3A's orbit prompt
ORBIT_PROMPT_TEMPLATE = (
    "The camera rotates around the scene, maintaining constant distance: "
    "`{prompt}`. The orbiting trajectory captures 3D structure and "
    "consistency."
)
NEGATIVE_PROMPT = ""


# --------------------------------------------------------------------------- #
# T5 v1.1                                                                     #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_sequence_length: int = 226


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model))
        self.q = _Dense(cfg.d_model, inner)
        self.k = _Dense(cfg.d_model, inner)
        self.v = _Dense(cfg.d_model, inner)
        self.o = _Dense(inner, cfg.d_model)
        if has_bias:
            self.rel_bias = nn.Parameter(torch.empty(
                cfg.relative_attention_num_buckets, cfg.num_heads))
        self.ln2 = nn.Parameter(torch.empty(cfg.d_model))
        self.wi_0 = _Dense(cfg.d_model, cfg.d_ff)
        self.wi_1 = _Dense(cfg.d_model, cfg.d_ff)
        self.wo = _Dense(cfg.d_ff, cfg.d_model)


class T5Encoder(nn.Module):
    """The relative-attention bias lives in layer 0 only
    (`has_relative_attention_bias=bool(i == 0)`) and every layer adds it."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.layers = nn.ModuleList([T5Layer(cfg, i == 0)
                                     for i in range(cfg.num_layers)])
        self.final_ln = nn.Parameter(torch.empty(cfg.d_model))


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int, max_distance: int
                             ) -> torch.Tensor:
    """HF `T5Attention._relative_position_bucket`, bidirectional."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(n < max_exact, n, large)


def _t5_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """HF `T5LayerNorm`: scale only, the mean square in float32."""
    var = x.float().pow(2).mean(-1, keepdim=True)
    return scale * (x.float() * torch.rsqrt(var + eps)).to(scale.dtype)


@torch.no_grad()
def t5_encode(model: T5Encoder, input_ids: torch.Tensor) -> torch.Tensor:
    """input_ids (B, N) → last hidden state (B, N, d_model) in the weights'
    dtype, every position attended (CogVideoX passes no mask)."""
    cfg = model.cfg
    dev = model.embed.device
    ids = input_ids.to(dev)
    b, n = ids.shape
    h, dk = cfg.num_heads, cfg.d_kv
    pos = torch.arange(n, device=dev)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    position_bias = model.layers[0].rel_bias[buckets].permute(2, 0, 1)[None]
    x = model.embed[ids]
    for layer in model.layers:
        y = _t5_norm(x, layer.ln1, cfg.layer_norm_eps)
        q = (y @ layer.q.weight.T).view(b, n, h, dk).transpose(1, 2)
        k = (y @ layer.k.weight.T).view(b, n, h, dk).transpose(1, 2)
        v = (y @ layer.v.weight.T).view(b, n, h, dk).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) + position_bias   # no 1/√d scale
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        attn = (probs @ v).transpose(1, 2).reshape(b, n, h * dk)
        x = x + attn @ layer.o.weight.T
        y = _t5_norm(x, layer.ln2, cfg.layer_norm_eps)
        gated = F.gelu(y @ layer.wi_0.weight.T, approximate="tanh") \
            * (y @ layer.wi_1.weight.T)
        x = x + gated @ layer.wo.weight.T
    return _t5_norm(x, model.final_ln, cfg.layer_norm_eps)


@torch.no_grad()
def embed(t5: T5Encoder, tokenize, prompt: str, device,
          negative_prompt: str = NEGATIVE_PROMPT):
    """(cond, uncond) embeddings (1, N, d_model): the orbit template around
    the prompt and the negative prompt, each tokenised and encoded without
    a mask."""
    out = []
    for text in (ORBIT_PROMPT_TEMPLATE.format(prompt=prompt), negative_prompt):
        ids, _ = tokenize(text)
        out.append(t5_encode(t5, torch.as_tensor(np.asarray(ids),
                                                 device=device)))
    return out[0], out[1]


# --------------------------------------------------------------------------- #
# the CogVideoX DiT                                                           #
# --------------------------------------------------------------------------- #
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


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.inner_dim, p, stride=p)
        self.text_proj = nn.Linear(cfg.text_embed_dim, cfg.inner_dim)


class _TimeEmbedding(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.linear_1 = nn.Linear(cfg.inner_dim, cfg.time_embed_dim)
        self.linear_2 = nn.Linear(cfg.time_embed_dim, cfg.time_embed_dim)


class _LayerNormZero(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.linear = nn.Linear(cfg.time_embed_dim, 6 * cfg.inner_dim)
        self.norm = nn.LayerNorm(cfg.inner_dim, eps=cfg.norm_eps)


class _Attention(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        d, dh = cfg.inner_dim, cfg.attention_head_dim
        self.to_q = nn.Linear(d, d)
        self.to_k = nn.Linear(d, d)
        self.to_v = nn.Linear(d, d)
        self.norm_q = nn.LayerNorm(dh, eps=cfg.qk_norm_eps)
        self.norm_k = nn.LayerNorm(dh, eps=cfg.qk_norm_eps)
        self.to_out = nn.Linear(d, d)


class _FeedForward(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.proj = nn.Linear(cfg.inner_dim, cfg.ffn_dim)
        self.out = nn.Linear(cfg.ffn_dim, cfg.inner_dim)


class _Block(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.norm1 = _LayerNormZero(cfg)
        self.attn1 = _Attention(cfg)
        self.norm2 = _LayerNormZero(cfg)
        self.ff = _FeedForward(cfg)


class _AdaLayerNorm(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.linear = nn.Linear(cfg.time_embed_dim, 2 * cfg.inner_dim)
        self.norm = nn.LayerNorm(cfg.inner_dim, eps=cfg.norm_eps)


class CogVideoXDiT(nn.Module):
    def __init__(self, cfg: CogVideoXConfig = CogVideoXConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.time_embedding = _TimeEmbedding(cfg)
        self.transformer_blocks = nn.ModuleList(
            [_Block(cfg) for _ in range(cfg.num_layers)])
        self.norm_final = nn.LayerNorm(cfg.inner_dim, eps=cfg.norm_eps)
        self.norm_out = _AdaLayerNorm(cfg)
        self.proj_out = nn.Linear(cfg.inner_dim,
                                  cfg.out_channels * cfg.patch_size ** 2)


def timestep_sinusoid(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers `get_timestep_embedding(flip_sin_to_cos=True,
    downscale_freq_shift=0)`, float32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = timesteps[:, None].float() * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return torch.cat([emb[:, half:], emb[:, :half]], dim=-1)


def rotary_tables(cfg: CogVideoXConfig, t: int, h: int, w: int, device):
    """diffusers `get_3d_rotary_pos_embed(use_real=True)` at positions
    0..n−1: (cos, sin), each (t·h·w, head_dim) float32, every frequency
    repeated for its pair."""
    d = cfg.attention_head_dim
    dims = (d // 4, d // 8 * 3, d // 8 * 3)

    def one_axis(dim, n):
        freqs = 1.0 / (cfg.rope_theta ** (
            torch.arange(0, dim, 2, dtype=torch.float32)[:dim // 2] / dim))
        ang = torch.outer(torch.arange(n, dtype=torch.float32), freqs)
        return (ang.cos().repeat_interleave(2, dim=1),
                ang.sin().repeat_interleave(2, dim=1))

    out = []
    for k in range(2):
        ft, fh, fw = (one_axis(dim, n)[k] for dim, n in zip(dims, (t, h, w)))
        grid = torch.cat([ft[:, None, None].expand(t, h, w, -1),
                          fh[None, :, None].expand(t, h, w, -1),
                          fw[None, None, :].expand(t, h, w, -1)], dim=-1)
        out.append(grid.reshape(t * h * w, d).to(device))
    return out[0], out[1]


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """diffusers `apply_rotary_emb(use_real=True, use_real_unbind_dim=-1)`
    on x (B, H, S, D)."""
    x_real, x_imag = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    rotated = torch.stack([-x_imag, x_real], dim=-1).flatten(3)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def softmax_attention(q, k, v, scale: float):
    """(B, H, S, D) softmax attention over blocks of `QUERY_BLOCK`
    queries: scores and softmax in float32, the probabilities cast to the
    inputs' dtype for the product with v."""
    kt = k.float().transpose(-1, -2)
    out = []
    for i in range(0, q.shape[2], QUERY_BLOCK):
        s = q[:, :, i:i + QUERY_BLOCK].float() @ kt
        p = torch.softmax(s * scale, dim=-1).to(v.dtype)
        del s
        out.append(p @ v)
    return torch.cat(out, dim=2)


def _joint_attention(attn: _Attention, x, e, rope, cfg: CogVideoXConfig):
    """`CogVideoXAttnProcessor2_0`: text first, RoPE on the video part."""
    n_text = e.shape[1]
    hs = torch.cat([e, x], dim=1)
    b, s, _ = hs.shape
    heads, dh = cfg.num_attention_heads, cfg.attention_head_dim

    def split(t):
        return t.view(b, s, heads, dh).transpose(1, 2)

    q, k, v = split(attn.to_q(hs)), split(attn.to_k(hs)), split(attn.to_v(hs))
    q, k = attn.norm_q(q), attn.norm_k(k)
    q = torch.cat([q[:, :, :n_text], apply_rotary(q[:, :, n_text:], *rope)],
                  dim=2)
    k = torch.cat([k[:, :, :n_text], apply_rotary(k[:, :, n_text:], *rope)],
                  dim=2)
    o = softmax_attention(q, k, v, dh ** -0.5)
    o = attn.to_out(o.transpose(1, 2).reshape(b, s, heads * dh))
    return o[:, n_text:], o[:, :n_text]


def _block(blk: _Block, x, e, emb, rope, cfg: CogVideoXConfig):
    """`CogVideoXBlock`: each sub-layer's `CogVideoXLayerNormZero` gives
    each modality its own shift, scale and gate."""
    n_text = e.shape[1]
    mod = blk.norm1.linear(F.silu(emb))[:, None]
    shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
    nx = blk.norm1.norm(x) * (1 + scale) + shift
    ne = blk.norm1.norm(e) * (1 + e_scale) + e_shift
    ax, ae = _joint_attention(blk.attn1, nx, ne, rope, cfg)
    x = x + gate * ax
    e = e + e_gate * ae
    mod = blk.norm2.linear(F.silu(emb))[:, None]
    shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
    nx = blk.norm2.norm(x) * (1 + scale) + shift
    ne = blk.norm2.norm(e) * (1 + e_scale) + e_shift
    hs = torch.cat([ne, nx], dim=1)
    ff = blk.ff.out(F.gelu(blk.ff.proj(hs), approximate="tanh"))
    return x + gate * ff[:, n_text:], e + e_gate * ff[:, :n_text]


@torch.no_grad()
def dit_forward(model: CogVideoXDiT, latent: torch.Tensor,
                timestep: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """latent (B, 16, T, H, W), timestep (B,), text (B, L, 4096) → v
    (B, 16, T, H, W), all in the weights' dtype."""
    cfg = model.cfg
    dt = model.proj_out.weight.dtype
    p = cfg.patch_size
    x = latent.to(dt).permute(0, 2, 1, 3, 4)           # (B, T, C, H, W)
    b, t, c, hh, ww = x.shape
    emb = model.time_embedding.linear_2(F.silu(model.time_embedding.linear_1(
        timestep_sinusoid(timestep, cfg.inner_dim).to(dt))))
    e = model.patch_embed.text_proj(text.to(dt))
    x = model.patch_embed.proj(x.reshape(b * t, c, hh, ww))
    x = x.view(b, t, *x.shape[1:]).flatten(3).transpose(2, 3).flatten(1, 2)
    rope = rotary_tables(cfg, t, hh // p, ww // p, x.device)
    for blk in model.transformer_blocks:
        x, e = _block(blk, x, e, emb, rope, cfg)
    x = model.norm_final(x)
    shift, scale = model.norm_out.linear(F.silu(emb))[:, None].chunk(2, dim=-1)
    x = model.norm_out.norm(x) * (1 + scale) + shift
    x = model.proj_out(x)
    x = x.reshape(b, t, hh // p, ww // p, -1, p, p)
    x = x.permute(0, 1, 4, 2, 5, 3, 6).flatten(5, 6).flatten(3, 4)
    return x.permute(0, 2, 1, 3, 4)


# --------------------------------------------------------------------------- #
# DDIM with v-prediction, and the chain with CFG                              #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """CogVideoX-5B's `scheduler/scheduler_config.json`."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    snr_shift_scale: float = 1.0


def alphas_cumprod(cfg: SchedulerConfig) -> torch.Tensor:
    """`CogVideoXDDIMScheduler.alphas_cumprod` (float64): scaled-linear
    betas, the SNR shift, `rescale_zero_terminal_snr`."""
    betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, dtype=torch.float64) ** 2
    ac = torch.cumprod(1.0 - betas, dim=0)
    ac = ac / (cfg.snr_shift_scale + (1 - cfg.snr_shift_scale) * ac)
    root = ac.sqrt()
    root_0, root_t = root[0].clone(), root[-1].clone()
    root = (root - root_t) * (root_0 / (root_0 - root_t))
    return root ** 2


def schedule(cfg: SchedulerConfig, num_steps: int) -> list:
    """[(t, ᾱ_t, ᾱ_prev)] of each step: the "trailing" timesteps, ᾱ_prev
    = 1 past the last (`set_alpha_to_one`)."""
    ac = alphas_cumprod(cfg)
    n = cfg.num_train_timesteps
    ts = (np.round(np.arange(n, 0, -n / num_steps)).astype(np.int64) - 1)
    out = []
    for t in ts.tolist():
        prev = t - n // num_steps
        out.append((t, float(ac[t]), float(ac[prev]) if prev >= 0 else 1.0))
    return out


def ddim_step(x: torch.Tensor, v: torch.Tensor, a_t: float, a_prev: float):
    """`CogVideoXDDIMScheduler.step` with v-prediction and eta 0."""
    x0 = math.sqrt(a_t) * x - math.sqrt(1 - a_t) * v
    c = math.sqrt((1 - a_prev) / (1 - a_t))
    return c * x + (math.sqrt(a_prev) - math.sqrt(a_t) * c) * x0


def cfg_model(dit_apply, cond, uncond, guidance_scale: float):
    """The pipeline's CFG: the pair [uncond, cond] in one batch."""
    text = torch.cat([uncond, cond])

    def model_fn(x, t):
        ts = torch.full((2,), float(t), dtype=torch.float32, device=x.device)
        v_u, v_c = dit_apply(torch.cat([x, x]), ts, text).float().chunk(2)
        return v_u + guidance_scale * (v_c - v_u)
    return model_fn


def sample(model_fn, latents: torch.Tensor, cfg: SchedulerConfig,
           num_steps: int, steps: int | None = None) -> torch.Tensor:
    """The DDIM chain from `latents` over the first `steps` (all by
    default) of `num_steps`, the state in the latents' dtype."""
    x = latents
    for t, a_t, a_prev in schedule(cfg, num_steps)[:steps]:
        x = ddim_step(x, model_fn(x, t).to(x.dtype), a_t, a_prev)
    return x
