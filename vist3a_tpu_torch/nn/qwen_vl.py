"""Qwen2.5-VL, the UnifiedReward judge of the generation evaluation.

Port of `vist3a_tpu/nn/qwen_vl.py`.  The reference loads
`CodeGoat24/UnifiedReward-qwen-7b` (a Qwen2.5-VL-7B fine-tune) through HF
for DPG-Bench's yes/no VQA (`evaluation/gen_eval/dpg_evaluation.py:79-124`)
and the UnifiedReward alignment / coherence / style judge
(`evaluation/gen_eval/gen_metrics/unified_reward.py:57-133`):

  * vision tower (`QwenVLVision`, `vision_features`): the conv3d patch
    embed (2×14×14) as one matmul, RMSNorm + SwiGLU blocks, 2-D rotary
    embedding, 112-px window attention with full attention at blocks
    {7, 15, 23, 31}, the 2×2 merger MLP;
  * text decoder (`QwenVLText`, `text_forward`): Qwen2 GQA attention (q/k/v
    with bias, o without), SwiGLU MLP, RMSNorm, multimodal 3-D RoPE (mrope
    sections over t / h / w); `embed_tokens` scatters the image features
    onto the image-pad positions;
  * `greedy_generate`: a static KV cache, one prefill, then one token a
    step until an end token.

As in the JAX package, the ragged window attention (HF's cu_seqlens) is
one segment-masked attention over the window-permuted sequence, and the
window permutation, the rope tables and the 3-D positions are built on the
host (`window_partition`, `vision_rope_freqs`, `get_rope_index`).  Blocks
are a `ModuleList` run by a Python loop where JAX scans stacked params.
Attention is plain math (the JAX einsum + softmax): no TPU kernel lies on
this path.  A decode step attends over the cache's filled part only; the
JAX step masks the rest, which adds only exact zeros.

Numerics follow the JAX functions: `_rms_norm` takes the variance in fp32
and casts back before the weight multiply (Qwen2RMSNorm); `_lin` rounds the
fp32-accumulated product to the activation dtype and adds the bias there;
SiLU's logistic is 1 / (1 + exp(-x)) rounded at each step, as XLA
expands it; attention logits and softmax in fp32 with an additive bias,
the probabilities cast to v's dtype; the logits in fp32.  In bf16 a
decoder layer is bit-equal to the JAX layer run op by op.

Parameter names mirror the JAX tree (`convert.load_jax_qwen_vl_params`);
weights are (out, in), as HF stores them, so `import_hf_qwen_vl` only
renames (and reshapes the patch embed's conv weight): the vision tower's
`patch_embed` (D, C·2·14·14), `blocks.<i>.{norm1, norm2, qkv, proj,
mlp.{gate, up, down}}`, `merger.{ln_q, fc1, fc2}`; the decoder's `embed`
(V, D), `layers.<i>.{ln1, ln2, q, k, v, o, mlp.{gate, up, down}}`, `ln_f`
and `lm_head` (V, D).  The JAX package's tensor-parallel placement
(`text_param_shardings`, `place_text`) is not ported: this runs on one
card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vist3a_tpu_torch.core import mesh as mesh_mod
from vist3a_tpu_torch.nn.layers import build_random


# --------------------------------------------------------------------------- #
# configs                                                                     #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: int = 2
    window_size: int = 112
    out_hidden_size: int = 3584
    fullatt_block_indexes: tuple = (7, 15, 23, 31)
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size ** 2)


@dataclasses.dataclass(frozen=True)
class QwenVLTextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    rope_theta: float = 1000000.0
    mrope_section: tuple = (16, 24, 24)
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    eos_token_ids: tuple = (151645, 151643)   # <|im_end|>, <|endoftext|>

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


QWEN25_VL_7B_VISION = QwenVLVisionConfig()
QWEN25_VL_7B_TEXT = QwenVLTextConfig()


# --------------------------------------------------------------------------- #
# shared numerics                                                             #
# --------------------------------------------------------------------------- #
def _rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 variance, cast back BEFORE the weight multiply (Qwen2RMSNorm)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * w.to(x.dtype)


class _Linear(nn.Module):
    """Weight (out, in) ~ N(0, 0.02²), zero bias (the JAX `_lin_init`)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=0.02, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """`_lin`: the product accumulated in fp32 and rounded to x's dtype,
        then the bias added in that dtype."""
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class _SwiGLU(nn.Module):
    def __init__(self, d: int, hidden: int, bias: bool):
        super().__init__()
        self.gate = _Linear(d, hidden, bias)
        self.up = _Linear(d, hidden, bias)
        self.down = _Linear(hidden, d, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SiLU as XLA computes `jax.nn.silu`: the logistic expanded to
        1 / (1 + exp(-g)), each step rounded to g's dtype."""
        g = self.gate(x)
        s = torch.exp(-g).add_(1.0).reciprocal_()
        return self.down(s.mul_(g).mul_(self.up(x)))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    tf = t.float()
    return (tf * cos.float() + _rotate_half(tf) * sin.float()).to(t.dtype)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q (N, H, D), k / v (M, KV, D) with H a multiple of KV (query head h
    reads kv head h // (H / KV), the JAX `jnp.repeat`), bias an additive
    fp32 mask broadcastable to (H, N, M) → (N, H, D): fp32 logits and
    softmax, the probabilities cast to v's dtype, fp32 accumulation."""
    n, h, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(n, kv, h // kv, d)
    logits = torch.einsum("ngrd,mgd->grnm", qg.float(), k.float()) * scale
    probs = torch.softmax(
        logits.reshape(h, n, -1) + bias, dim=-1).reshape(logits.shape)
    out = torch.einsum("grnm,mgd->ngrd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(n, h, d).to(v.dtype)


# --------------------------------------------------------------------------- #
# host-side static helpers (numpy; exact HF semantics)                        #
# --------------------------------------------------------------------------- #
def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280):
    """Qwen2VLImageProcessor.smart_resize: round to multiples of `factor`
    within the pixel budget, preserving aspect ratio."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio must be < 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def patchify(frames: np.ndarray, cfg: QwenVLVisionConfig):
    """(T, C, H, W) float frames (already resized+normalized) → flat patches
    (grid_t·grid_h·grid_w, C·tp·ps·ps) in the HF processor's merge-group
    order, plus the (t, h, w) grid."""
    ps, tp, m = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
    t, c, h, w = frames.shape
    if t % tp:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], tp - t % tp, axis=0)], axis=0)
    gt, gh, gw = frames.shape[0] // tp, h // ps, w // ps
    p = frames.reshape(gt, tp, c, gh // m, m, ps, gw // m, m, ps)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (p.reshape(gt * gh * gw, c * tp * ps * ps).astype(np.float32),
            (gt, gh, gw))


def vision_rope_freqs(grid, cfg: QwenVLVisionConfig) -> np.ndarray:
    """(S, head_dim//2) rotary angles in merge-group token order."""
    gt, gh, gw = grid
    m = cfg.spatial_merge_size
    hpos = np.arange(gh)[:, None] * np.ones((1, gw), np.int64)
    wpos = np.ones((gh, 1), np.int64) * np.arange(gw)[None, :]

    def grouped(a):
        return a.reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3).ravel()

    pos = np.stack([grouped(hpos), grouped(wpos)], axis=-1)   # (gh·gw, 2)
    pos = np.tile(pos, (gt, 1))
    dim = cfg.head_dim // 4
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, dtype=np.float64) / dim))
    return (pos[:, :, None] * inv[None, None]).reshape(pos.shape[0], -1) \
        .astype(np.float32)


def window_partition(grid, cfg: QwenVLVisionConfig):
    """HF `get_window_index` for one grid: returns (window_index — the
    merge-group permutation, window segment id per *patch* token, image
    segment id per patch token)."""
    gt, gh, gw = grid
    m = cfg.spatial_merge_size
    lh, lw = gh // m, gw // m
    win = cfg.window_size // m // cfg.patch_size
    pad_h, pad_w = (-lh) % win or win, (-lw) % win or win
    # HF pads by `win - l % win` even when l % win == 0 (a full extra pad
    # block of -100s that is then dropped) — result is the same permutation
    nh, nw = (lh + pad_h) // win, (lw + pad_w) // win
    idx = np.full((gt, lh + pad_h, lw + pad_w), -100, np.int64)
    idx[:, :lh, :lw] = np.arange(gt * lh * lw).reshape(gt, lh, lw)
    idx = idx.reshape(gt, nh, win, nw, win).transpose(0, 1, 3, 2, 4)
    idx = idx.reshape(-1, win, win)
    seqlens = (idx != -100).sum((1, 2))
    flat = idx.reshape(-1)
    window_index = flat[flat != -100]
    # segment id per merge group, then expand to the 4 patches of the group
    group_seg = np.repeat(np.arange(len(seqlens)), seqlens)
    unit = m * m
    win_seg = np.repeat(group_seg, unit)
    img_seg = np.zeros(gt * lh * lw * unit, np.int64)
    return window_index, win_seg, img_seg


def segment_bias(seg: np.ndarray) -> np.ndarray:
    """(S,) segment ids → (1, S, S) additive fp32 mask (0 inside a segment,
    −inf across)."""
    same = seg[:, None] == seg[None, :]
    return np.where(same, 0.0, -np.inf).astype(np.float32)[None]


def get_rope_index(input_ids: np.ndarray, image_grid_thw,
                   cfg: QwenVLTextConfig,
                   vision_cfg: QwenVLVisionConfig,
                   second_per_grid_ts=None, video_grid_thw=None):
    """3D mrope position ids for ONE sequence (judge runs batch 1).
    input_ids: (L,) int; grids: list of (t, h, w) per <image>/<video>
    placeholder run.  Returns ((3, L) int32, delta:int)."""
    m = vision_cfg.spatial_merge_size
    toks = list(map(int, input_ids))
    image_grid_thw = list(image_grid_thw or [])
    video_grid_thw = list(video_grid_thw or [])
    pos_list = []
    st, img_i, vid_i = 0, 0, 0
    n_vision = sum(1 for i, t in enumerate(toks)
                   if t == cfg.vision_start_token_id and i + 1 < len(toks)
                   and toks[i + 1] in (cfg.image_token_id, cfg.video_token_id))
    for _ in range(n_vision):
        ed_img = toks.index(cfg.image_token_id, st) \
            if cfg.image_token_id in toks[st:] else len(toks) + 1
        ed_vid = toks.index(cfg.video_token_id, st) \
            if cfg.video_token_id in toks[st:] else len(toks) + 1
        if ed_img < ed_vid:
            t, h, w = image_grid_thw[img_i]
            img_i += 1
            spg = 0.0
            ed = ed_img
        else:
            t, h, w = video_grid_thw[vid_i]
            spg = (second_per_grid_ts[vid_i]
                   if second_per_grid_ts is not None else 1.0)
            vid_i += 1
            ed = ed_vid
        lt, lh, lw = int(t), int(h) // m, int(w) // m
        text_len = ed - st
        st_idx = pos_list[-1].max() + 1 if pos_list else 0
        pos_list.append(np.tile(np.arange(text_len), (3, 1)) + st_idx)
        t_idx = np.repeat(
            (np.arange(lt) * spg * vision_cfg.tokens_per_second).astype(
                np.int64), lh * lw)
        h_idx = np.tile(np.repeat(np.arange(lh), lw), lt)
        w_idx = np.tile(np.arange(lw), lt * lh)
        pos_list.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
        st = ed + lt * lh * lw
    if st < len(toks):
        st_idx = pos_list[-1].max() + 1 if pos_list else 0
        pos_list.append(np.tile(np.arange(len(toks) - st), (3, 1)) + st_idx)
    pos = np.concatenate(pos_list, axis=1).astype(np.int32)
    return pos, int(pos.max()) + 1 - len(toks)


# --------------------------------------------------------------------------- #
# vision tower                                                                #
# --------------------------------------------------------------------------- #
class QwenVLVisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.Parameter(torch.empty(d))
        self.norm2 = nn.Parameter(torch.empty(d))
        self.qkv = _Linear(d, 3 * d)
        self.proj = _Linear(d, d)
        self.mlp = _SwiGLU(d, cfg.intermediate_size, bias=True)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.norm1)
        nn.init.ones_(self.norm2)


class QwenVLMerger(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        mh = cfg.hidden_size * cfg.spatial_merge_size ** 2
        self.ln_q = nn.Parameter(torch.empty(cfg.hidden_size))
        self.fc1 = _Linear(mh, mh)
        self.fc2 = _Linear(mh, cfg.out_hidden_size)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.ln_q)


class QwenVLVision(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig = QWEN25_VL_7B_VISION):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Parameter(torch.empty(cfg.hidden_size,
                                                    cfg.patch_dim))
        self.blocks = nn.ModuleList(QwenVLVisionBlock(cfg)
                                    for _ in range(cfg.depth))
        self.merger = QwenVLMerger(cfg)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.patch_embed, std=0.02, generator=generator)


def vision_features(model: QwenVLVision, patches: torch.Tensor,
                    grid) -> torch.Tensor:
    """patches: (S, C·tp·ps·ps) flat patch pixels for ONE image in the HF
    processor's order, on the tower's device, in its dtype; grid (t, h, w)
    → (S // merge², out_hidden)."""
    cfg = model.cfg
    unit = cfg.spatial_merge_size ** 2
    widx, win_seg, img_seg = window_partition(grid, cfg)
    freqs = vision_rope_freqs(grid, cfg)               # (S, dh/2)
    s = patches.shape[0]
    dev = patches.device
    x = F.linear(patches, model.patch_embed.to(patches.dtype))
    # permute merge groups into window order (static per grid)
    widx_t = torch.from_numpy(widx).to(dev)
    x = x.reshape(s // unit, unit, -1)[widx_t].reshape(s, -1)
    freqs = freqs.reshape(s // unit, unit, -1)[widx].reshape(s, -1)
    emb = np.concatenate([freqs, freqs], axis=-1)
    cos = torch.from_numpy(np.cos(emb)).to(dev)[:, None, :]   # (S, 1, dh)
    sin = torch.from_numpy(np.sin(emb)).to(dev)[:, None, :]
    # win_seg is already in window order (built from per-window seqlens);
    # img_seg is all zeros for a single image
    win_bias = torch.from_numpy(segment_bias(win_seg)).to(dev)
    full_bias = torch.from_numpy(segment_bias(img_seg)).to(dev)
    scale = cfg.head_dim ** -0.5
    h, dh = cfg.num_heads, cfg.head_dim
    for i, blk in enumerate(model.blocks):
        bias = full_bias if i in cfg.fullatt_block_indexes else win_bias
        y = _rms_norm(blk.norm1, x, cfg.eps)
        q, k, v = blk.qkv(y).chunk(3, dim=-1)
        q = _rope(q.reshape(s, h, dh), cos, sin)
        k = _rope(k.reshape(s, h, dh), cos, sin)
        o = _masked_attention(q, k, v.reshape(s, h, dh), bias, scale)
        x = x + blk.proj(o.reshape(s, -1))
        x = x + blk.mlp(_rms_norm(blk.norm2, x, cfg.eps))
    # merger: RMSNorm then 2x2-group MLP
    m = model.merger
    y = _rms_norm(m.ln_q, x, cfg.eps).reshape(s // unit, -1)
    y = m.fc2(F.gelu(m.fc1(y)))
    # undo the window permutation
    return y[torch.from_numpy(np.argsort(widx)).to(dev)]


# --------------------------------------------------------------------------- #
# text decoder                                                                #
# --------------------------------------------------------------------------- #
class QwenVLTextLayer(nn.Module):
    tp = None   # core/mesh.py::TensorParallel, set by `place_text`

    def __init__(self, cfg: QwenVLTextConfig):
        super().__init__()
        d, dh = cfg.hidden_size, cfg.head_dim
        self.ln1 = nn.Parameter(torch.empty(d))
        self.ln2 = nn.Parameter(torch.empty(d))
        self.q = _Linear(d, cfg.num_heads * dh)
        self.k = _Linear(d, cfg.num_kv_heads * dh)
        self.v = _Linear(d, cfg.num_kv_heads * dh)
        self.o = _Linear(cfg.num_heads * dh, d, bias=False)
        self.mlp = _SwiGLU(d, cfg.intermediate_size, bias=False)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.ln1)
        nn.init.ones_(self.ln2)


class QwenVLText(nn.Module):
    def __init__(self, cfg: QwenVLTextConfig = QWEN25_VL_7B_TEXT):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.layers = nn.ModuleList(QwenVLTextLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = nn.Parameter(torch.empty(d))
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Parameter(torch.empty(cfg.vocab_size, d)))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.embed, std=0.02, generator=generator)
        nn.init.ones_(self.ln_f)
        if self.lm_head is not None:
            nn.init.normal_(self.lm_head, std=0.02, generator=generator)


def vision_init(cfg: QwenVLVisionConfig, generator: torch.Generator,
                device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32) -> QwenVLVision:
    """A vision tower with random weights drawn (on `device`, in `dtype`)
    from the JAX `vision_init` distributions with `generator`."""
    return build_random(lambda: QwenVLVision(cfg), generator, device, dtype)


def text_init(cfg: QwenVLTextConfig, generator: torch.Generator,
              device: torch.device | str = "cuda",
              dtype: torch.dtype = torch.float32) -> QwenVLText:
    """A text decoder with random weights drawn from the JAX `text_init`
    distributions with `generator`."""
    return build_random(lambda: QwenVLText(cfg), generator, device, dtype)


def _mrope_tables(pos_ids: torch.Tensor, cfg: QwenVLTextConfig,
                  dtype: torch.dtype):
    """pos_ids (3, L) → cos / sin (L, 1, head_dim) in `dtype`, the mrope
    sections choosing the t, h or w angle of each rotary dimension."""
    half = cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=pos_ids.device)
        / half))
    freqs = pos_ids[:, :, None].float() * inv[None, None]          # 3, L, h
    emb = torch.cat([freqs, freqs], dim=-1)                        # 3, L, dh
    sections = list(cfg.mrope_section) * 2
    sel = torch.from_numpy(np.repeat(np.arange(len(sections)) % 3,
                                     sections)).to(pos_ids.device)
    mixed = emb.gather(0, sel.view(1, 1, -1).expand(1, emb.shape[1], -1))[0]
    return (torch.cos(mixed).to(dtype)[:, None, :],
            torch.sin(mixed).to(dtype)[:, None, :])


def _text_layer(layer: QwenVLTextLayer, x, cos, sin, kcache, vcache,
                cache_pos: int, bias, cfg: QwenVLTextConfig):
    """One decoder layer over (L, D) tokens at cache rows [cache_pos,
    cache_pos + L), attending over rows [0, cache_pos + L) of the updated
    cache slices kcache / vcache (Lmax, kvh, dh)."""
    l = x.shape[0]
    dh = cfg.head_dim
    # this rank's heads (all of them unless `place_text` cut the layer)
    h, kvh = layer.q.weight.shape[0] // dh, layer.k.weight.shape[0] // dh
    tp = layer.tp
    y = _rms_norm(layer.ln1, x, cfg.rms_eps)
    q = _rope(layer.q(y).reshape(l, h, dh), cos, sin)
    k = _rope(layer.k(y).reshape(l, kvh, dh), cos, sin)
    kcache[cache_pos:cache_pos + l] = k
    vcache[cache_pos:cache_pos + l] = layer.v(y).reshape(l, kvh, dh)
    m = cache_pos + l
    o = _masked_attention(q, kcache[:m], vcache[:m], bias, dh ** -0.5)
    # o and down are row-parallel under TP (no biases): the partial
    # products summed over the model group
    attn = layer.o(o.reshape(l, -1))
    if tp is not None:
        attn = mesh_mod.reduce_from_model(attn, tp.group)
    x = x + attn
    mlp = layer.mlp(_rms_norm(layer.ln2, x, cfg.rms_eps))
    if tp is not None:
        mlp = mesh_mod.reduce_from_model(mlp, tp.group)
    return x + mlp


def local_kv_heads(model: QwenVLText) -> int:
    """The kv heads this rank holds: all, or its share under `place_text`
    (the static KV cache holds only those)."""
    return model.layers[0].k.weight.shape[0] // model.cfg.head_dim


def text_forward(model: QwenVLText, embeds: torch.Tensor,
                 pos_ids: torch.Tensor, *, kcache=None, vcache=None,
                 cache_pos: int = 0, last_only: bool = False):
    """embeds (L, D); pos_ids (3, L).  Returns (logits (L, V) fp32, kcache,
    vcache).  With a cache ((layers, Lmax, kvh, dh), written in place),
    computes the step at `cache_pos`; without, allocates one of exactly L.

    last_only=True computes the logits of the FINAL position only (1, V):
    greedy prefill needs no other row."""
    cfg = model.cfg
    l = embeds.shape[0]
    dev = embeds.device
    if kcache is None:
        kcache = torch.zeros((cfg.num_layers, l, local_kv_heads(model),
                              cfg.head_dim), dtype=embeds.dtype, device=dev)
        vcache = torch.zeros_like(kcache)
        cache_pos = 0
    cos, sin = _mrope_tables(pos_ids.to(dev), cfg, embeds.dtype)
    # causal by absolute position over the cache's filled rows
    key_pos = torch.arange(cache_pos + l, device=dev)
    q_pos = cache_pos + torch.arange(l, device=dev)
    keep = key_pos[None, :] <= q_pos[:, None]
    bias = torch.where(keep, 0.0, float("-inf"))[None]   # (1, L, M) fp32
    x = embeds
    for i, layer in enumerate(model.layers):
        x = _text_layer(layer, x, cos, sin, kcache[i], vcache[i], cache_pos,
                        bias, cfg)
    if last_only:
        x = x[-1:]
    x = _rms_norm(model.ln_f, x, cfg.rms_eps)
    w = model.embed if model.lm_head is None else model.lm_head
    logits = x.float() @ w.float().T
    return logits, kcache, vcache


def embed_tokens(model: QwenVLText, input_ids: torch.Tensor,
                 image_embeds: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings with the image features scattered onto the
    <|image_pad|> positions, in order (the k-th pad takes row k, clamped
    to the last row as the JAX gather clamps)."""
    ids = input_ids.to(model.embed.device, torch.long)
    x = model.embed[ids]
    if image_embeds is not None:
        is_img = ids == model.cfg.image_token_id
        slot = torch.clamp(torch.cumsum(is_img, 0) - 1, 0,
                           image_embeds.shape[0] - 1)
        x = torch.where(is_img[:, None], image_embeds[slot].to(x.dtype), x)
    return x


def greedy_generate(model: QwenVLText, input_ids: np.ndarray, image_embeds,
                    pos_ids: np.ndarray, delta: int,
                    max_new_tokens: int = 512) -> list:
    """Greedy decode (batch 1).  input_ids: (L,) host ints; image_embeds:
    (S, D) or None; pos_ids / delta from `get_rope_index`.  Returns the
    generated token ids (stops at an end token): one prefill over the
    prompt into a static cache of L + max_new_tokens rows, then one token
    a step."""
    cfg = model.cfg
    dev = model.embed.device
    l = len(input_ids)
    lmax = l + max_new_tokens
    with torch.no_grad():
        x = embed_tokens(model, torch.as_tensor(np.asarray(input_ids)),
                         image_embeds)
        kc = torch.zeros((cfg.num_layers, lmax, local_kv_heads(model),
                          cfg.head_dim), dtype=x.dtype, device=dev)
        vc = torch.zeros_like(kc)
        logits, kc, vc = text_forward(
            model, x, torch.as_tensor(np.asarray(pos_ids)), kcache=kc,
            vcache=vc, cache_pos=0, last_only=True)
        tok = torch.argmax(logits[-1])
        out = []
        for i in range(max_new_tokens):
            t = int(tok)
            if t in cfg.eos_token_ids:
                break
            out.append(t)
            x = model.embed[tok][None]
            pos = torch.full((3, 1), l + i + delta, dtype=torch.int32,
                             device=dev)
            logits, kc, vc = text_forward(model, x, pos, kcache=kc,
                                          vcache=vc, cache_pos=l + i)
            tok = torch.argmax(logits[-1])
    return out


# --------------------------------------------------------------------------- #
# tensor-parallel placement (the 7B judge over a model group)                 #
# --------------------------------------------------------------------------- #
_TEXT_COLUMN = ("q", "k", "v", "gate", "up")
_TEXT_ROW = ("o", "down")


def _text_tp_dim(name: str) -> int | None:
    parts = name.split(".")
    if parts[0] != "layers" or len(parts) < 4:
        return None
    if parts[-2] in _TEXT_COLUMN:
        return 0
    if parts[-2] in _TEXT_ROW and parts[-1] == "weight":
        return 1
    return None


def text_tp_slices(state: dict[str, torch.Tensor], size: int, rank: int
                   ) -> dict[str, torch.Tensor]:
    """The text decoder's weights (`named_parameters` names) → this rank's
    Megatron slices (`vist3a_tpu/nn/qwen_vl.py::text_param_shardings`):
    q/k/v/gate/up keep their output rows (and biases), o/down their input
    columns; the embeddings, the norms and `lm_head` stay whole."""
    return mesh_mod.tp_slice_state(state, _text_tp_dim, size, rank)


def place_text(model: QwenVLText, mesh, *, axis: str = "model"
               ) -> QwenVLText:
    """Cut the text decoder, in place, to this rank's slices over the
    mesh's `axis` group (`core/mesh.py`; `text_tp_slices`): each layer then
    runs num_heads/model query heads and num_kv_heads/model kv heads (the
    GQA groups stay whole), its static KV cache holds only those, and the
    o and down products are summed over the group.  The group's size must
    divide num_kv_heads (4 at 7B: model ∈ {2, 4}).  A mesh without process
    groups places nothing."""
    group = mesh.group(axis)
    if group is None:
        return model
    tp = mesh_mod.tensor_parallel_group(group)
    cfg = model.cfg
    if cfg.num_kv_heads % tp.size or cfg.intermediate_size % tp.size:
        raise ValueError(f"{cfg.num_kv_heads} kv heads / intermediate "
                         f"{cfg.intermediate_size} do not split over a "
                         f"model axis of {tp.size}")
    mesh_mod.cut_to_slices(model, _text_tp_dim, tp)
    for layer in model.layers:
        layer.tp = tp
    return model


# --------------------------------------------------------------------------- #
# HF weight import                                                            #
# --------------------------------------------------------------------------- #
def _find_prefix(keys, cands) -> str:
    for c in cands:
        if any(k.startswith(c) for k in keys):
            return c
    raise KeyError(f"none of {cands} in state dict")


def import_hf_qwen_vl(sd: dict, vision_cfg: QwenVLVisionConfig,
                      text_cfg: QwenVLTextConfig) -> tuple[dict, dict]:
    """HF `Qwen2_5_VLForConditionalGeneration` state dict → (a
    `QwenVLVision`'s state dict, a `QwenVLText`'s).  Accepts both the
    `model.language_model.` / `model.visual.` (transformers ≥ 4.52) and
    the legacy `model.` / `visual.` prefixes.  Raises on a key of the file
    that it does not consume."""
    keys = list(sd.keys())
    vp = _find_prefix(keys, ["model.visual.", "visual."])
    tp = _find_prefix(keys, ["model.language_model.", "model."])
    used = set()

    def take(k):
        used.add(k)
        return sd[k]

    def lin(out, ours, theirs, bias=True):
        out[f"{ours}.weight"] = take(f"{theirs}.weight")
        if bias:
            out[f"{ours}.bias"] = take(f"{theirs}.bias")

    vision = {}
    pe = take(f"{vp}patch_embed.proj.weight")        # (D, C, tp, ps, ps)
    vision["patch_embed"] = pe.reshape(pe.shape[0], -1)
    for i in range(vision_cfg.depth):
        b, o = f"{vp}blocks.{i}", f"blocks.{i}"
        vision[f"{o}.norm1"] = take(f"{b}.norm1.weight")
        vision[f"{o}.norm2"] = take(f"{b}.norm2.weight")
        lin(vision, f"{o}.qkv", f"{b}.attn.qkv")
        lin(vision, f"{o}.proj", f"{b}.attn.proj")
        for name in ("gate", "up", "down"):
            lin(vision, f"{o}.mlp.{name}", f"{b}.mlp.{name}_proj")
    vision["merger.ln_q"] = take(f"{vp}merger.ln_q.weight")
    lin(vision, "merger.fc1", f"{vp}merger.mlp.0")
    lin(vision, "merger.fc2", f"{vp}merger.mlp.2")

    text = {"embed": take(f"{tp}embed_tokens.weight"),
            "ln_f": take(f"{tp}norm.weight")}
    for i in range(text_cfg.num_layers):
        b, o = f"{tp}layers.{i}", f"layers.{i}"
        text[f"{o}.ln1"] = take(f"{b}.input_layernorm.weight")
        text[f"{o}.ln2"] = take(f"{b}.post_attention_layernorm.weight")
        for name in "qkv":
            lin(text, f"{o}.{name}", f"{b}.self_attn.{name}_proj")
        lin(text, f"{o}.o", f"{b}.self_attn.o_proj", bias=False)
        for name in ("gate", "up", "down"):
            lin(text, f"{o}.mlp.{name}", f"{b}.mlp.{name}_proj", bias=False)
    if not text_cfg.tie_embeddings:
        text["lm_head"] = take("lm_head.weight")
    unused = sorted(k for k in keys if k not in used)
    if unused:
        raise ValueError(f"{len(unused)} keys of the Qwen2.5-VL state dict "
                         f"not consumed, first 20: {unused[:20]}")
    return vision, text
