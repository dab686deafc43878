"""CLIP towers with their projections: the reward's scorers.

Port of `vist3a_tpu/nn/clip.py`: the two frozen scorers of the reference's
`utils/reward.py` — PickScore_v1 (HF CLIP-H/14 at 224², `get_image_features`
/ `get_text_features`, :42-57, :152-158) and DFN5B-CLIP-ViT-H-14-378
(open_clip `encode_image` / `encode_text`, :93-111, :171-174).

  * Vision (`CLIPVision`, `image_features`): a patch conv without bias, a
    class token, learned position embeddings, a pre-LN, N layers of (LN,
    multi-head attention, LN, MLP), a post-LN of the class token and a
    linear projection, L2-normalised.  The reward needs gradients through
    it, so `image_features` recomputes each layer in the backward (the JAX
    package's per-layer `jax.checkpoint`).
  * Text (`CLIPText`, `text_features`): token and position embeddings, N
    causal layers, a final LN, the features pooled at argmax(ids) (the
    end-of-text token has the highest id in the CLIP vocabulary, so this
    is HF's and open_clip's pooling under either padding), the projection
    and the L2 norm.  The reward uses them frozen, once per prompt.
  * The importers `import_hf_clip_vision`, `import_open_clip_vision`,
    `import_hf_clip_text` and `import_open_clip_text` map a reference state
    dict (HF `CLIPModel`, open_clip `VisionTransformer` / text tower) onto
    these modules' names; their result loads strictly.

Attention is plain math (the JAX `impl="xla"`; N = 257, 730 and ≤ 248 text
positions are below the flash threshold anyway).  Numerics follow the JAX
functions: LayerNorm statistics in fp32, cast back; a linear rounds its
product to the activation dtype and adds the bias in that dtype; GELU
exact (erf).  Parameter names mirror the JAX tree
(`convert.load_jax_clip_vision_params` / `load_jax_clip_text_params`):
`patch` (OIHW here, HWIO there), `class_embedding`, `pos_embed`, `ln_pre`,
`layers.<i>.{ln1, q, k, v, o, ln2, fc1, fc2}`, `ln_post`, `proj`
((width, projection_dim), as in JAX); the text tower's `token_embed`,
`pos_embed`, `layers`, `ln_final`, `proj`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vist3a_tpu_torch.nn.layers import LayerNorm, build_random, recompute
from vist3a_tpu_torch.ops.attention import plain_attention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 1024
    act: str = "gelu"            # laion-H / DFN5B use plain gelu
    ln_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


CLIP_H_224 = CLIPVisionConfig()
DFN5B_H_378 = CLIPVisionConfig(image_size=378)


class _Linear(nn.Module):
    """Weight (out, in) ~ N(0, 1/in), zero bias (the JAX `_linear_init`)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=self.weight.shape[1] ** -0.5,
                        generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.ln1 = LayerNorm(d, cfg.ln_eps)
        self.q, self.k, self.v, self.o = (_Linear(d, d) for _ in range(4))
        self.ln2 = LayerNorm(d, cfg.ln_eps)
        self.fc1 = _Linear(d, cfg.mlp_dim)
        self.fc2 = _Linear(cfg.mlp_dim, d)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """mask: an additive (N, N) fp32 mask (the text tower's causal
        one), or None (the vision tower's full attention)."""
        b, n, d = x.shape
        h = self.cfg.num_heads
        y = self.ln1(x)
        q, k, v = (lin(y).reshape(b, n, h, d // h)
                   for lin in (self.q, self.k, self.v))
        if mask is None:
            attn = plain_attention(q, k, v)
        else:
            # the JAX `_text_layer`: fp32 logits, the mask added after the
            # scale, the probabilities cast to v's dtype
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
                * (d // h) ** -0.5 + mask
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + self.o(attn.reshape(b, n, d))
        y = self.fc1(self.ln2(x))
        if self.cfg.act == "gelu":
            y = F.gelu(y)
        elif self.cfg.act == "quick_gelu":
            y = y * torch.sigmoid(1.702 * y)
        else:
            raise ValueError(self.cfg.act)
        return x + self.fc2(y)


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIP_H_224):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.cfg = cfg
        self.patch = nn.Parameter(torch.empty(d, 3, p, p))
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.pos_embed = nn.Parameter(torch.empty(cfg.grid ** 2 + 1, d))
        self.ln_pre = LayerNorm(d, cfg.ln_eps)
        self.layers = nn.ModuleList(CLIPLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_post = LayerNorm(d, cfg.ln_eps)
        self.proj = nn.Parameter(torch.empty(d, cfg.projection_dim))

    def init_params(self, generator: torch.Generator) -> None:
        for t in (self.patch, self.class_embedding, self.pos_embed):
            nn.init.normal_(t, std=0.02, generator=generator)
        nn.init.normal_(self.proj, std=self.cfg.hidden_size ** -0.5,
                        generator=generator)


def init(cfg: CLIPVisionConfig, generator: torch.Generator,
         device: torch.device | str = "cuda",
         dtype: torch.dtype = torch.float32) -> CLIPVision:
    """A tower with random weights drawn (in `dtype`, on `device`) from the
    JAX `init` distributions with `generator` (which must live on
    `device`)."""
    return build_random(lambda: CLIPVision(cfg), generator, device, dtype)


def _layer(layer: CLIPLayer, x: torch.Tensor) -> torch.Tensor:
    return layer(x)


def image_features(model: CLIPVision, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, 3, H, W), CLIP-normalised → L2-normalised (B,
    projection_dim) features in the pixels' dtype; in the caller's grad
    mode, each layer recomputed in the backward."""
    cfg = model.cfg
    dt = pixels.dtype
    b = pixels.shape[0]
    x = F.conv2d(pixels, model.patch.to(dt), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)                        # (B, N, D)
    cls = model.class_embedding.to(dt).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + model.pos_embed.to(dt)[None]
    x = model.ln_pre(x)
    for layer in model.layers:
        x = recompute(_layer, layer, x)
    pooled = model.ln_post(x[:, 0])
    feats = (pooled @ model.proj.to(dt)).to(dt)
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


# --------------------------------------------------------------------------- #
# text tower                                                                  #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """The CLIP-H text tower (both reward scorers: width 1024, 24 layers,
    16 heads, 77 positions)."""
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    vocab_size: int = 49408
    context_length: int = 77
    projection_dim: int = 1024
    act: str = "gelu"
    ln_eps: float = 1e-5

    def layer_config(self) -> CLIPVisionConfig:
        """The shared layer's config (the JAX `text_init`'s `vcfg`)."""
        return CLIPVisionConfig(hidden_size=self.hidden_size,
                                num_heads=self.num_heads,
                                mlp_dim=self.mlp_dim, act=self.act,
                                ln_eps=self.ln_eps)


CLIP_H_TEXT = CLIPTextConfig()
# ViT-L/14 text tower (openai lineage, quick_gelu): CLIPScore
# ("openai/clip-vit-large-patch14") and LongCLIP-L
# ("zer0int/LongCLIP-L-Diffusers", 248 positions, an HF CLIPModel) of
# `evaluation/gen_eval/t3_scene_evaluation.py:96-101`
CLIP_L_TEXT = CLIPTextConfig(hidden_size=768, num_layers=12, num_heads=12,
                             mlp_dim=3072, projection_dim=768,
                             act="quick_gelu")
LONGCLIP_L_TEXT = dataclasses.replace(CLIP_L_TEXT, context_length=248)


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIP_H_TEXT):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.token_embed = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos_embed = nn.Parameter(torch.empty(cfg.context_length, d))
        self.layers = nn.ModuleList(CLIPLayer(cfg.layer_config())
                                    for _ in range(cfg.num_layers))
        self.ln_final = LayerNorm(d, cfg.ln_eps)
        self.proj = nn.Parameter(torch.empty(d, cfg.projection_dim))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.token_embed, std=0.02, generator=generator)
        nn.init.normal_(self.pos_embed, std=0.01, generator=generator)
        nn.init.normal_(self.proj, std=self.cfg.hidden_size ** -0.5,
                        generator=generator)


def text_init(cfg: CLIPTextConfig, generator: torch.Generator,
              device: torch.device | str = "cuda",
              dtype: torch.dtype = torch.float32) -> CLIPText:
    """A text tower with random weights drawn from the JAX `text_init`
    distributions with `generator` (which must live on `device`)."""
    return build_random(lambda: CLIPText(cfg), generator, device, dtype)


def text_features(model: CLIPText, ids: torch.Tensor, *,
                  normalize: bool = True) -> torch.Tensor:
    """ids (B, N ≤ context_length) CLIP-BPE token ids → (B, projection_dim)
    in the tower's dtype: causal attention, pooled at argmax(ids) (the
    first end-of-text token), projected, L2-normalised."""
    b, n = ids.shape
    ids = ids.to(model.token_embed.device, torch.long)
    x = model.token_embed[ids] + model.pos_embed[None, :n]
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    for layer in model.layers:
        x = layer(x, mask)
    x = model.ln_final(x)
    pooled = x[torch.arange(b, device=x.device), ids.argmax(dim=-1)]
    feats = (pooled @ model.proj.to(pooled.dtype)).to(pooled.dtype)
    if normalize:
        feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats


# --------------------------------------------------------------------------- #
# importers: reference state dicts → these modules' state dicts              #
# --------------------------------------------------------------------------- #
_HF_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
            ("o", "out_proj"))


def _hf_layers(sd: dict, prefix: str, num_layers: int) -> dict:
    out = {}
    for i in range(num_layers):
        p, o = f"{prefix}.{i}", f"layers.{i}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"),
                             *((a, f"self_attn.{b}") for a, b in _HF_ATTN)):
            out[f"{o}.{ours}.weight"] = sd[f"{p}.{theirs}.weight"]
            out[f"{o}.{ours}.bias"] = sd[f"{p}.{theirs}.bias"]
    return out


def _open_clip_layers(sd: dict, prefix: str, num_layers: int) -> dict:
    out = {}
    for i in range(num_layers):
        p, o = f"{prefix}.{i}", f"layers.{i}"
        w, b = sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"]
        d = w.shape[1]
        for j, name in enumerate("qkv"):
            out[f"{o}.{name}.weight"] = w[j * d:(j + 1) * d]
            out[f"{o}.{name}.bias"] = b[j * d:(j + 1) * d]
        for ours, theirs in (("o", "attn.out_proj"), ("ln1", "ln_1"),
                             ("ln2", "ln_2"), ("fc1", "mlp.c_fc"),
                             ("fc2", "mlp.c_proj")):
            out[f"{o}.{ours}.weight"] = sd[f"{p}.{theirs}.weight"]
            out[f"{o}.{ours}.bias"] = sd[f"{p}.{theirs}.bias"]
    return out


def _ln(sd: dict, prefix: str, ours: str) -> dict:
    return {f"{ours}.weight": sd[f"{prefix}.weight"],
            f"{ours}.bias": sd[f"{prefix}.bias"]}


def import_hf_clip_vision(sd: dict, num_layers: int) -> dict:
    """HF `CLIPModel` / `CLIPVisionModelWithProjection` state dict (prefix
    'vision_model.' and 'visual_projection.') → a `CLIPVision`'s."""
    pre = ("vision_model.pre_layrnorm"
           if "vision_model.pre_layrnorm.weight" in sd
           else "vision_model.pre_layernorm")
    return {
        "patch": sd["vision_model.embeddings.patch_embedding.weight"],
        "class_embedding":
            sd["vision_model.embeddings.class_embedding"].reshape(-1),
        "pos_embed": sd["vision_model.embeddings.position_embedding.weight"],
        **_ln(sd, pre, "ln_pre"),
        **_hf_layers(sd, "vision_model.encoder.layers", num_layers),
        **_ln(sd, "vision_model.post_layernorm", "ln_post"),
        "proj": sd["visual_projection.weight"].T.contiguous(),
    }


def import_open_clip_vision(sd: dict, num_layers: int) -> dict:
    """open_clip `VisionTransformer` state dict (prefix 'visual.') → a
    `CLIPVision`'s."""
    return {
        "patch": sd["visual.conv1.weight"],
        "class_embedding": sd["visual.class_embedding"],
        "pos_embed": sd["visual.positional_embedding"],
        **_ln(sd, "visual.ln_pre", "ln_pre"),
        **_open_clip_layers(sd, "visual.transformer.resblocks", num_layers),
        **_ln(sd, "visual.ln_post", "ln_post"),
        "proj": sd["visual.proj"],
    }


def import_hf_clip_text(sd: dict, num_layers: int) -> dict:
    """HF `CLIPModel` / `CLIPTextModelWithProjection` state dict (prefix
    'text_model.' and 'text_projection.') → a `CLIPText`'s."""
    return {
        "token_embed": sd["text_model.embeddings.token_embedding.weight"],
        "pos_embed": sd["text_model.embeddings.position_embedding.weight"],
        **_hf_layers(sd, "text_model.encoder.layers", num_layers),
        **_ln(sd, "text_model.final_layer_norm", "ln_final"),
        "proj": sd["text_projection.weight"].T.contiguous(),
    }


def import_open_clip_text(sd: dict, num_layers: int) -> dict:
    """open_clip text tower (unprefixed 'transformer.resblocks.*',
    'token_embedding', 'positional_embedding', 'ln_final',
    'text_projection') → a `CLIPText`'s."""
    return {
        "token_embed": sd["token_embedding.weight"],
        "pos_embed": sd["positional_embedding"],
        **_open_clip_layers(sd, "transformer.resblocks", num_layers),
        **_ln(sd, "ln_final", "ln_final"),
        "proj": sd["text_projection"],
    }
