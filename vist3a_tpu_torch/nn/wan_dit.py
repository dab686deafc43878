"""Wan 2.1 text-to-video diffusion transformer (DiT).

Port of `vist3a_tpu/nn/wan_dit.py` (diffusers `WanTransformer3DModel`):
  * patchify: conv3d k = s = (1, 2, 2), 16 → dim channels;
  * condition embedder in fp32: sinusoidal timestep [cos | sin] → MLP →
    SiLU → Linear(dim, 6·dim), the per-step adaLN vector; text:
    Linear(text_dim, dim) → GELU(tanh) → Linear(dim, dim);
  * N blocks: adaLN over {self-attention with 3D RoPE and a fused QKV,
    text cross-attention after an affine fp32 LayerNorm, GELU(tanh) MLP};
    q/k RMSNorm across the full inner dim;
  * 3D RoPE: head_dim split (t, h, w) = (d − 4⌊d/6⌋, 2⌊d/6⌋, 2⌊d/6⌋),
    θ = 10000, a complex rotation of consecutive (even, odd) pairs — not
    the rotate-half of `ops/rope.py`;
  * head: fp32 LayerNorm modulated by a 2-chunk table, linear to 16·1·2·2,
    unpatchify.

The JAX package's rounding points are kept: a linear layer rounds its
product to the activation dtype and then adds the bias in that dtype; the
attn1 and MLP residuals are gated in fp32 and rounded once; the attn2
residual is added in the activation dtype.  Self-attention goes through the
attention dispatch (the natural-layout flash kernel on the card: head_dim
128, 4096 tokens at 512²); cross-attention over the 226 text tokens is
plain math (`impl="plain"`), as the JAX package sends it to XLA.  In
inference without TP, the biases, the q/k RMSNorm and RoPE between the
q/k/v products and the attention run in one kernel
(`kernels/qk_prologue.py`), at the same rounding points; with grad they
run as its plain version's torch ops.

The RoPE tables are built on the host in float64, as in the JAX package,
but once per (grid, device) and kept on the model: the denoise calls the
DiT 50 times on one grid.

`forward(remat=False)` is the inference entry, run in inference mode.
`forward(remat=True)` is the training entry, in the caller's grad mode:
each block is recomputed in the backward, and `lora` (factors keyed
`blocks.<i>.<site>`, from `stitch.lora.init_lora` on the DiT) is merged
into the block's weights inside the block's forward, so merged q/k/v/o
weights live for one block at a time (the JAX `lora_blocks` / `merge_fn`
of `wan_dit.forward`); under FSDP2 (`core/mesh.py::place_dit`) that is
where the block's weights are gathered.

`tensor_parallel` cuts the blocks to this rank's slices over a model
group (the port's `param_shardings`, Megatron's layout), with the
collectives written out: an autograd-aware copy at each column-parallel
input, an all-reduce after each row-parallel product with its bias added
after it, and the qk-norm's mean of squares summed over the group.

Weights: `convert.load_jax_dit_params` (the patch kernel is DHWIO there,
OIDHW here; linear weights (in, out) there, (out, in) here), or `init`,
which draws them from the JAX `init` distributions on the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vist3a_tpu_torch.core.mesh import (TensorParallel, copy_to_model,
                                        cut_to_slices, reduce_from_model,
                                        sum_over_model, tensor_parallel_group,
                                        tp_slice_state)
from vist3a_tpu_torch.core.profiling import span
from vist3a_tpu_torch.kernels.qk_prologue import (qk_prologue,
                                                  qk_prologue_ref)
from vist3a_tpu_torch.nn.layers import build_random
from vist3a_tpu_torch.ops.attention import dot_product_attention
from vist3a_tpu_torch.stitch import lora as lora_mod


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
WAN_14B = WanDiTConfig(dim=5120, ffn_dim=13824, num_layers=40, num_heads=40)


def config_from_model_id(model_id: str) -> WanDiTConfig:
    """`--model_id` → DiT scale, as the JAX package selects it."""
    return WAN_14B if "14B" in str(model_id) else WAN_1_3B


# --------------------------------------------------------------------------- #
# pieces                                                                      #
# --------------------------------------------------------------------------- #
class WanLinear(nn.Module):
    """Weight (out, in) and bias, uniform ±1/√d_in at init; the product is
    rounded to x's dtype before the bias is added in that dtype."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out))

    def init_params(self, generator: torch.Generator) -> None:
        bound = self.weight.shape[1] ** -0.5
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        nn.init.uniform_(self.bias, -bound, bound, generator=generator)

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
    tp: TensorParallel | None = None

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

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.norm_q)
        nn.init.ones_(self.norm_k)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                rope: tuple | None = None) -> torch.Tensor:
        return attention(dict(self.named_parameters()), x, context, rope,
                         self.cfg, self.tp)


def _linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """`WanLinear.forward` with the weights of `p`."""
    return (F.linear(x, p[f"{name}.weight"].to(x.dtype))
            + p[f"{name}.bias"].to(x.dtype))


def _row_linear(p: dict, name: str, x: torch.Tensor,
                tp: TensorParallel | None) -> torch.Tensor:
    """A row-parallel linear: the partial product all-reduced over the
    model group, then the bias added once."""
    if tp is None:
        return _linear(p, name, x)
    y = reduce_from_model(F.linear(x, p[f"{name}.weight"].to(x.dtype)),
                          tp.group)
    return y + p[f"{name}.bias"].to(x.dtype)


def _rms_across_heads(scale: torch.Tensor, x: torch.Tensor, eps: float,
                      d_full: int, tp: TensorParallel) -> torch.Tensor:
    """RMSNorm over the full inner dim under TP: each rank holds d/model of
    it, so the mean of squares is summed over the model group (each rank's
    mean weighted by its share) before the rsqrt."""
    xf = x.float()
    ms = sum_over_model(
        xf.square().mean(-1, keepdim=True) * (x.shape[-1] / d_full),
        tp.group)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def attention(p: dict, x: torch.Tensor, context: torch.Tensor | None,
              rope: tuple | None, cfg: WanDiTConfig,
              tp: TensorParallel | None = None) -> torch.Tensor:
    """Self-attention (context None: one fused QKV product, RoPE, the
    dispatch's kernel) or cross-attention (plain math), with the weights
    of `p` ({"q.weight", ..., "norm_q", "norm_k"}).  Under TP they are this
    rank's slices: its heads, H/model of them.

    Without TP the biases, the q/k RMSNorm and RoPE run in `_prologue`.
    Under TP they run as the torch ops below, since the statistic is summed
    over the model group between the square and the rsqrt."""
    b, n, _ = x.shape
    if tp is None:
        q, k, v, impl = _prologue(p, x, context, rope, cfg)
        out = dot_product_attention(q, k, v, impl=impl)
        return _linear(p, "o", out.reshape(b, n, -1))
    dh = cfg.head_dim
    d = p["q.weight"].shape[0]                # the local inner width
    h = d // dh
    x = copy_to_model(x, tp.group)
    if context is None:
        w = torch.cat([p["q.weight"], p["k.weight"], p["v.weight"]])
        bias = torch.cat([p["q.bias"], p["k.bias"], p["v.bias"]])
        qkv = F.linear(x, w.to(x.dtype)) + bias.to(x.dtype)
        q, k, v = qkv.split(d, dim=-1)
        context_len, impl = n, "auto"
    else:
        context = copy_to_model(context, tp.group)
        q, k, v = (_linear(p, "q", x), _linear(p, "k", context),
                   _linear(p, "v", context))
        context_len, impl = context.shape[1], "plain"
    q = _rms_across_heads(p["norm_q"], q, cfg.eps, cfg.dim, tp
                          ).reshape(b, n, h, dh)
    k = _rms_across_heads(p["norm_k"], k, cfg.eps, cfg.dim, tp
                          ).reshape(b, context_len, h, dh)
    v = v.reshape(b, context_len, h, dh)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    out = dot_product_attention(q, k, v, impl=impl)
    return _row_linear(p, "o", out.reshape(b, n, d), tp)


def _prologue(p: dict, x: torch.Tensor, context: torch.Tensor | None,
              rope: tuple | None, cfg: WanDiTConfig) -> tuple:
    """(q, k, v, the dispatch's impl) through the q/k prologue, one call
    for the self-attention's fused QKV product, one each for the
    cross-attention's q and k (its v only adds a bias).  In inference
    that is the kernel (`qk_prologue`); with grad enabled its plain
    version, the same torch ops, as the kernel has no backward."""
    prologue = qk_prologue_ref if torch.is_grad_enabled() else qk_prologue
    dh, eps = cfg.head_dim, cfg.eps
    if context is None:
        w = torch.cat([p["q.weight"], p["k.weight"], p["v.weight"]])
        qkv = F.linear(x, w.to(x.dtype))
        q, k, v = prologue(qkv, (p["q.bias"], p["k.bias"], p["v.bias"]),
                           (p["norm_q"], p["norm_k"]), eps, dh, rope)
        return q, k, v, "auto"
    (q,) = prologue(F.linear(x, p["q.weight"].to(x.dtype)),
                    (p["q.bias"],), (p["norm_q"],), eps, dh)
    (k,) = prologue(F.linear(context, p["k.weight"].to(context.dtype)),
                    (p["k.bias"],), (p["norm_k"],), eps, dh)
    v = _linear(p, "v", context).reshape(k.shape)
    return q, k, v, "plain"


class AffineNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class WanBlock(nn.Module):
    tp: TensorParallel | None = None

    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.cfg = cfg
        self.scale_shift_table = nn.Parameter(torch.empty(6, cfg.dim))
        self.attn1 = WanAttention(cfg)
        self.attn2 = WanAttention(cfg)
        self.norm2 = AffineNorm(cfg.dim)
        self.ffn = WanMLP(cfg.dim, cfg.ffn_dim, cfg.dim)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.scale_shift_table, std=self.cfg.dim ** -0.5,
                        generator=generator)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                temb6: torch.Tensor, rope: tuple, factors: dict | None = None,
                lora_cfg=None) -> torch.Tensor:
        """x (B, N, D), text (B, L, D), temb6 (B, 6, D) fp32; the weights
        merged with the LoRA `factors` if given.  The merge reads the
        block's parameters here, inside its forward, where FSDP2 has
        gathered them; under TP the replicated factors are cut to this
        rank's slices (`_tp_factors`)."""
        p = dict(self.named_parameters())
        if factors:
            p = lora_mod.merge_lora(p, _tp_factors(factors, self.tp),
                                    lora_cfg)
        return block_forward(p, x, text, temb6, rope, self.cfg, self.tp)


def _sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def block_forward(p: dict, x: torch.Tensor, text: torch.Tensor,
                  temb6: torch.Tensor, rope: tuple, cfg: WanDiTConfig,
                  tp: TensorParallel | None = None) -> torch.Tensor:
    """One block with the weights of `p` (the block's parameter names)."""
    eps = cfg.eps
    mods = p["scale_shift_table"].float()[None] + temb6
    sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (
        mods[:, i][:, None] for i in range(6))
    dtype = x.dtype

    y = (_fp32_ln(x, eps) * (1 + sc_msa) + sh_msa).to(dtype)
    attn = attention(_sub(p, "attn1."), y, None, rope, cfg, tp)
    x = (x.float() + attn.float() * g_msa).to(dtype)

    y = _fp32_ln(x, eps, p["norm2.weight"], p["norm2.bias"]).to(dtype)
    x = x + attention(_sub(p, "attn2."), y, text, None, cfg, tp)

    y = (_fp32_ln(x, eps) * (1 + sc_mlp) + sh_mlp).to(dtype)
    if tp is not None:
        y = copy_to_model(y, tp.group)
    ff = _row_linear(p, "ffn.fc2", F.gelu(_linear(p, "ffn.fc1", y),
                                          approximate="tanh"), tp)
    return (x.float() + ff.float() * g_mlp).to(dtype)


class PatchEmbedding(nn.Module):
    """conv3d weight (dim, in, pt, ph, pw), uniform ±1/√fan_in; zero bias."""

    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.dim, cfg.in_channels,
                                               *cfg.patch_size))
        self.bias = nn.Parameter(torch.empty(cfg.dim))

    def init_params(self, generator: torch.Generator) -> None:
        bound = math.prod(self.weight.shape[1:]) ** -0.5
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        nn.init.zeros_(self.bias)


class WanDiT(nn.Module):
    """The parameters of the JAX tree, one module per block."""

    tp: TensorParallel | None = None

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

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.scale_shift_table, std=self.cfg.dim ** -0.5,
                        generator=generator)

    def rope(self, grid: tuple, device: torch.device) -> tuple:
        """The RoPE tables of `grid`, built on the host once per grid and
        device, as normal tensors whatever the caller's mode."""
        key = (grid, str(device))
        if key not in self._rope:
            # built outside inference mode, so that a training step after
            # an inference call can save them for its backward
            with torch.inference_mode(False):
                self._rope[key] = tuple(
                    t.to(device) for t in rope_tables(self.cfg, *grid))
        return self._rope[key]

    def forward(self, latent: torch.Tensor, timestep: torch.Tensor,
                text_embeds: torch.Tensor, remat: bool = False,
                lora: dict | None = None, lora_cfg=None) -> torch.Tensor:
        """The DiT in the caller's grad mode; the module-level `forward`
        is the entry (it picks the mode).  A span `dit.forward`
        (`core/profiling.span`), closed before the module's forward hooks
        run."""
        with span("dit.forward"):
            return _forward(self, latent, timestep, text_embeds, remat, lora,
                            lora_cfg)


def init(cfg: WanDiTConfig, generator: torch.Generator,
         device: torch.device | str = "cuda",
         dtype: torch.dtype = torch.float32) -> WanDiT:
    """A DiT with random weights drawn, in `dtype` and on `device`, from the
    JAX `init` distributions with `generator` (which must live on
    `device`)."""
    return build_random(lambda: WanDiT(cfg), generator, device, dtype)


def forward(model: WanDiT, latent: torch.Tensor, timestep: torch.Tensor,
            text_embeds: torch.Tensor, *, remat: bool = False,
            lora: dict | None = None,
            lora_cfg: "lora_mod.LoraConfig | None" = None) -> torch.Tensor:
    """latent (B, 16, T, H, W) in the activation dtype; timestep (B,) float
    (σ·1000); text_embeds (B, L, text_dim).  Returns the predicted velocity
    (B, 16, T, H, W) in latent's dtype.  remat: the training entry (each
    block recomputed in the backward, with grad enabled); lora: factors
    merged per block (see the module docstring).  The model is called as a
    module, so that FSDP2's hooks gather its weights; remat=False runs
    under `no_grad` for an FSDP2-sharded model (its gathered buffers must
    not become inference tensors that a later step with gradients reads),
    else in inference mode."""
    if not remat:
        with torch.no_grad() if _fsdp_sharded(model) \
                else torch.inference_mode():
            return model(latent, timestep, text_embeds, False, lora,
                         lora_cfg)
    return model(latent, timestep, text_embeds, True, lora, lora_cfg)


def _fsdp_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def _forward(model, latent, timestep, text_embeds, remat, lora, lora_cfg):
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
    per_block = lora_mod.factors_by_block(lora or {}, len(model.blocks))
    for blk, factors in zip(model.blocks, per_block):
        def fn(x, blk=blk, factors=factors):
            return blk(x, text, temb6, rope, factors, lora_cfg)
        x = checkpoint(fn, x, use_reentrant=False) \
            if remat and torch.is_grad_enabled() else fn(x)

    mods = model.scale_shift_table.float()[None] + temb.float()[:, None]
    shift, scale = mods[:, 0][:, None], mods[:, 1][:, None]
    x = (_fp32_ln(x, cfg.eps) * (1 + scale) + shift).to(dtype)
    x = model.proj_out(x)

    x = x.reshape(b, *grid, pt, ph, pw, cfg.out_channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)              # B,C,gt,pt,gh,ph,gw,pw
    return x.reshape(b, cfg.out_channels, t, hh, ww)


# --------------------------------------------------------------------------- #
# tensor parallelism                                                          #
# --------------------------------------------------------------------------- #
# Megatron's layout (`vist3a_tpu/nn/wan_dit.py::param_shardings`): q/k/v and
# ffn.fc1 keep the rows of this rank's heads / hidden units (their biases
# and the qk-norm scales with them), o and ffn.fc2 the input columns
_COLUMN_SITES = ("q", "k", "v", "fc1")
_ROW_SITES = ("o", "fc2")


def _tp_dim(name: str) -> int | None:
    """The dim of parameter `name` (the DiT's names) that TP splits, or
    None (replicated)."""
    parts = name.split(".")
    if parts[0] != "blocks" or len(parts) < 4:
        return None
    site, leaf = parts[-2], parts[-1]
    if leaf in ("norm_q", "norm_k") or site in _COLUMN_SITES:
        return 0
    if site in _ROW_SITES and leaf == "weight":
        return 1
    return None


def tp_slices(state: dict[str, torch.Tensor], size: int, rank: int
              ) -> dict[str, torch.Tensor]:
    """Full DiT weights (`named_parameters` names: a state dict, or
    `convert.load_jax_dit_params`'s) → this rank's TP slices, views of
    the given tensors; the other weights as given."""
    return tp_slice_state(state, _tp_dim, size, rank)


def _tp_factors(factors: dict, tp: TensorParallel | None) -> dict:
    """A block's replicated LoRA factors ({site: {"a" (in, r), "b" (r,
    out)}}) cut to this rank's slices of the merged delta: b's output
    columns at a column-parallel site, a's input rows at a row-parallel
    one.  The cut is differentiable, so each rank's factor gradient is the
    part of its slices (summed over the model group by
    `core/mesh.py::reduce_lora_grads`)."""
    if tp is None:
        return factors
    out = {}
    for site, f in factors.items():
        leaf = site.rsplit(".", 1)[-1]
        a, b = f["a"], f["b"]
        if leaf in _COLUMN_SITES:
            n = b.shape[1] // tp.size
            b = b.narrow(1, tp.rank * n, n)
        elif leaf in _ROW_SITES:
            n = a.shape[0] // tp.size
            a = a.narrow(0, tp.rank * n, n)
        out[site] = {"a": a, "b": b}
    return out


def tensor_parallel(model: WanDiT, group) -> WanDiT:
    """Cut `model`'s block weights, in place, to this rank's TP slices over
    `group` (`tp_slices`): q/k/v/fc1 column-parallel, o/fc2 row-parallel,
    the rest replicated.  Each block then runs H/model heads and
    ffn_dim/model hidden units: the hand-written attention on this rank's
    heads (the port's counterpart of `vist3a_tpu/kernels/partitioning.py`'s
    shard_map over heads), one all-reduce after each row-parallel product,
    its bias added after it, and the qk-norm's statistic summed over the
    group.  A head count or MLP width the group's size does not divide
    raises."""
    tp = tensor_parallel_group(group)
    cfg = model.cfg
    if cfg.num_heads % tp.size or cfg.ffn_dim % tp.size:
        raise ValueError(
            f"{cfg.num_heads} heads / ffn_dim {cfg.ffn_dim} do not split "
            f"over a model axis of {tp.size}")
    cut_to_slices(model, _tp_dim, tp)
    for blk in model.blocks:
        blk.tp = blk.attn1.tp = blk.attn2.tp = tp
    model.tp = tp
    return model
