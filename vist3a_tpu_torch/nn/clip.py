"""CLIP vision towers with their projections: the reward's image scorers.

Port of the vision half of `vist3a_tpu/nn/clip.py` (`:32-160`): the two
frozen scorers of the reference's `utils/reward.py` — PickScore_v1 (HF
CLIP-H/14 at 224², `get_image_features`, :42-57) and DFN5B-CLIP-ViT-H-14-378
(open_clip `encode_image`, :93-111).  Both are one structure: a patch conv
without bias, a class token, learned position embeddings, a pre-LN, N
layers of (LN, multi-head attention, LN, MLP), a post-LN of the class token
and a linear projection, L2-normalised.  The reward needs gradients through
the image tower, so `image_features` recomputes each layer in the backward
(the JAX package's per-layer `jax.checkpoint`).  Attention is
plain math (the JAX `impl="xla"`; N = 257 and 730 are below the flash
threshold anyway).  The text towers and the weight importers are ROADMAP
Queue 1, item 15: the reward takes text features as inputs.

Numerics follow the JAX functions: LayerNorm statistics in fp32, cast back;
a linear rounds its product to the activation dtype and adds the bias in
that dtype; GELU exact (erf).  Parameter names mirror the JAX tree
(`convert.load_jax_clip_vision_params`): `patch` (OIHW here, HWIO there),
`class_embedding`, `pos_embed`, `ln_pre`, `layers.<i>.{ln1, q, k, v, o, ln2,
fc1, fc2}`, `ln_post`, `proj` ((width, projection_dim), as in JAX).
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.cfg.num_heads
        y = self.ln1(x)
        q, k, v = (lin(y).reshape(b, n, h, d // h)
                   for lin in (self.q, self.k, self.v))
        x = x + self.o(plain_attention(q, k, v).reshape(b, n, d))
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
