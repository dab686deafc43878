"""UMT5 text encoder (Wan 2.1's prompt tower).

Port of `vist3a_tpu/nn/umt5.py` (HF `UMT5EncoderModel`, umt5-xxl: d_model
4096, 24 layers, 64 heads of 64, d_ff 10240, gated GELU) with Wan's
post-processing: embeddings past each sequence's length are zeroed.  What
UMT5 keeps apart from T5, and the port with it:
  * every layer owns its relative-attention-bias table;
  * no 1/√d scale on the logits;
  * pre-norm RMSNorm (scale only), gated GELU (tanh) MLP, a final RMSNorm;
  * padded keys get an additive −1e9 on the fp32 logits.

The attention is plain math, as in the JAX package: 226 tokens are too few
for the flash kernel.  Dense weights are `Linear` modules holding (out, in)
weights, the transpose of the JAX package's bare (in, out) arrays
(`convert.load_jax_umt5_params` carries them over); the norms, the bias
tables and the embedding keep their JAX names and layouts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vist3a_tpu_torch.nn.layers import build_random, linear, rms_norm

DENSE = ("q", "k", "v", "o", "wi_0", "wi_1", "wo")


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab_size: int = 256384
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_sequence_length: int = 226      # Wan's padding length


UMT5_XXL = UMT5Config()


def relative_position_bucket(relative_position: np.ndarray,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """HF `_relative_position_bucket`, bidirectional (a numpy copy of the
    JAX package's host-side table)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int32) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def _bucket_table(seq_len: int, cfg: UMT5Config) -> np.ndarray:
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    return relative_position_bucket(
        mem - ctx, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)          # (Q, K) int32


class _Dense(nn.Module):
    """A bias-free linear layer, weight (out, in), normal · d_in^−½ at init."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=self.weight.shape[1] ** -0.5,
                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight)


class UMT5Layer(nn.Module):
    def __init__(self, cfg: UMT5Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model))
        self.q = _Dense(cfg.d_model, inner)
        self.k = _Dense(cfg.d_model, inner)
        self.v = _Dense(cfg.d_model, inner)
        self.o = _Dense(inner, cfg.d_model)
        self.rel_bias = nn.Parameter(torch.empty(
            cfg.relative_attention_num_buckets, cfg.num_heads))
        self.ln2 = nn.Parameter(torch.empty(cfg.d_model))
        self.wi_0 = _Dense(cfg.d_model, cfg.d_ff)
        self.wi_1 = _Dense(cfg.d_model, cfg.d_ff)
        self.wo = _Dense(cfg.d_ff, cfg.d_model)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.ln1)
        nn.init.ones_(self.ln2)
        nn.init.normal_(self.rel_bias, std=0.1, generator=generator)

    def forward(self, x: torch.Tensor, bias_mask: torch.Tensor,
                buckets: torch.Tensor) -> torch.Tensor:
        """x (B, N, D); bias_mask (B, 1, 1, N) additive fp32; buckets (N, N)."""
        cfg = self.cfg
        b, n, _ = x.shape
        h, dk = cfg.num_heads, cfg.d_kv
        eps = cfg.layer_norm_eps
        y = rms_norm(self.ln1, x, eps)
        q = self.q(y).reshape(b, n, h, dk)
        k = self.k(y).reshape(b, n, h, dk)
        v = self.v(y).reshape(b, n, h, dk)
        pos_bias = self.rel_bias.float()[buckets].permute(2, 0, 1)  # (H, N, N)
        # fp32 logits, no 1/√d scale
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        logits = logits + pos_bias[None] + bias_mask
        probs = torch.softmax(logits, dim=-1).to(y.dtype)
        attn = torch.einsum("bhnm,bmhd->bnhd", probs.float(), v.float()
                            ).to(y.dtype)
        x = x + self.o(attn.reshape(b, n, h * dk))
        y = rms_norm(self.ln2, x, eps)
        ff = F.gelu(self.wi_0(y), approximate="tanh") * self.wi_1(y)
        return x + self.wo(ff)


class UMT5Encoder(nn.Module):
    def __init__(self, cfg: UMT5Config = UMT5_XXL):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.layers = nn.ModuleList([UMT5Layer(cfg)
                                     for _ in range(cfg.num_layers)])
        self.final_ln = nn.Parameter(torch.empty(cfg.d_model))
        self._buckets: dict = {}

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.embed, generator=generator)
        nn.init.ones_(self.final_ln)

    def buckets(self, seq_len: int, device: torch.device) -> torch.Tensor:
        """The (N, N) bucket table, built on the host once per length and
        device."""
        key = (seq_len, str(device))
        if key not in self._buckets:
            self._buckets[key] = torch.from_numpy(
                _bucket_table(seq_len, self.cfg).astype(np.int64)).to(device)
        return self._buckets[key]


def init(cfg: UMT5Config, generator: torch.Generator,
         device: torch.device | str = "cuda",
         dtype: torch.dtype = torch.float32) -> UMT5Encoder:
    """An encoder with random weights drawn, in `dtype` and on `device`,
    from the JAX `init` distributions with `generator` (which must live on
    `device`); umt5-xxl is 11.4 GB in bf16."""
    return build_random(lambda: UMT5Encoder(cfg), generator, device, dtype)


@torch.inference_mode()
def encode(model: UMT5Encoder, input_ids: torch.Tensor,
           attention_mask: torch.Tensor) -> torch.Tensor:
    """input_ids, attention_mask (B, N) ints → last hidden state (B, N, D)
    in the weights' dtype, zero past each sequence's length."""
    cfg = model.cfg
    dev = model.embed.device
    input_ids = input_ids.to(dev)
    live = attention_mask.to(dev) > 0
    x = model.embed[input_ids]
    bias_mask = torch.where(live[:, None, None, :], 0.0,
                            -1e9).to(torch.float32)
    buckets = model.buckets(input_ids.shape[1], dev)
    for layer in model.layers:
        x = layer(x, bias_mask, buckets)
    x = rms_norm(model.final_ln, x, cfg.layer_norm_eps)
    return x * live[..., None].to(x.dtype)
