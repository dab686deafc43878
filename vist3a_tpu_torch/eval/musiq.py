"""MUSIQ: the multi-scale image-quality transformer (SPAQ variant).

Port of `vist3a_tpu/eval/musiq.py`, the imaging-quality column of the
reference (`evaluation/gen_eval/gen_metrics/imaging_quality.py:32-62`,
pyiqa's `MUSIQ(pretrained_model_path=musiq_spaq_ckpt)`, reported as
mean(score)/100):

  * multi-scale input: the native image plus aspect-preserving resizes to a
    longer side of 224 and 384 (`jax.image.resize` bilinear, antialiased as
    it is by default there: `ops/resize.py`); every scale cut into 32×32
    patches, zero-padded at the right and bottom;
  * a linear patch projection to 384, a hash-based 2-D spatial embedding
    (patch (i, j) of a gh×gw grid → cell (⌊i·G/gh⌋, ⌊j·G/gw⌋) of one shared
    G×G = 10×10 table) and a learned embedding per scale (native 0, 224 →
    1, 384 → 2);
  * a class token and a pre-LN transformer (14 layers, hidden 384, 6 heads,
    MLP 1152, exact GELU) with the padded slots masked out of attention;
  * the final LayerNorm and a linear 384 → 1 on the class token: the MOS.

`preprocess_frame` is the reference's 'shorter' mode: a frame whose
shorter side exceeds 512 is resized bilinearly without antialiasing
(torchvision `Resize(antialias=False)`) by 512/shorter.  The scorer pads
each frame's tokens to a multiple of 64 and scores frame by frame.

Weights: `save_musiq_npz` / `load_musiq_npz` keep the JAX package's file
(flat keys like "blocks/3/qkv/w", linear weights (in, out)), so either
package reads the other's file; the load checks every key and shape and
refuses a mismatch.  The published pyiqa checkpoint is converted offline
(`eval/musiq_convert.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vist3a_tpu_torch.nn.clip import _Linear
from vist3a_tpu_torch.nn.layers import LayerNorm, build_random
from vist3a_tpu_torch.ops.resize import resize


@dataclasses.dataclass(frozen=True)
class MUSIQConfig:
    patch_size: int = 32
    hidden: int = 384
    num_layers: int = 14
    num_heads: int = 6
    mlp_dim: int = 1152
    hse_grid: int = 10                     # G×G hash grid
    longer_sides: tuple = (224, 384)       # resized scales
    max_native_side: int = 512             # reference preprocess cap
    ln_eps: float = 1e-6

    @property
    def num_scales(self) -> int:
        return 1 + len(self.longer_sides)

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size * self.patch_size


class MUSIQBlock(nn.Module):
    def __init__(self, cfg: MUSIQConfig):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.ln1 = LayerNorm(d, cfg.ln_eps)
        self.qkv = _Linear(d, 3 * d)
        self.proj = _Linear(d, d)
        self.ln2 = LayerNorm(d, cfg.ln_eps)
        self.fc1 = _Linear(d, cfg.mlp_dim)
        self.fc2 = _Linear(cfg.mlp_dim, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.cfg.num_heads
        qkv = self.qkv(self.ln1(x)).reshape(b, n, 3, h, d // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)              # (b, h, n, hd)
        att = (q @ k.transpose(-1, -2)) / np.sqrt(d // h)
        att = torch.where(mask[:, None, None, :], att,
                          torch.full((), -1e9, dtype=att.dtype,
                                     device=att.device))
        att = torch.softmax(att, dim=-1)
        y = (att @ v).transpose(1, 2).reshape(b, n, d)
        x = x + self.proj(y)
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class MUSIQ(nn.Module):
    def __init__(self, cfg: MUSIQConfig = MUSIQConfig()):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.patch_proj = _Linear(cfg.patch_dim, d)
        self.cls = nn.Parameter(torch.empty(1, 1, d))
        self.hse = nn.Parameter(torch.empty(cfg.hse_grid, cfg.hse_grid, d))
        self.scale_embed = nn.Parameter(torch.empty(cfg.num_scales, d))
        self.blocks = nn.ModuleList(MUSIQBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_out = LayerNorm(d, cfg.ln_eps)
        self.head = _Linear(d, 1)

    def init_params(self, generator: torch.Generator) -> None:
        for t in (self.cls, self.hse, self.scale_embed):
            nn.init.normal_(t, std=0.02, generator=generator)

    def forward(self, patches: torch.Tensor, hse_ids: torch.Tensor,
                scale_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """patches (B, N, patch_dim), hse_ids (B, N, 2), scale_ids (B, N),
        mask (B, N) bool (True = real patch) → MOS (B,).  Padded slots are
        masked out of attention and contribute nothing."""
        b = patches.shape[0]
        x = self.patch_proj(patches)
        x = x + self.hse[hse_ids[..., 0], hse_ids[..., 1]]
        x = x + self.scale_embed[scale_ids]
        x = x * mask[..., None]
        cls = self.cls.expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        full_mask = torch.cat([torch.ones(b, 1, dtype=torch.bool,
                                          device=mask.device),
                               mask.bool()], dim=1)
        for blk in self.blocks:
            x = blk(x, full_mask)
        x = self.ln_out(x)
        return self.head(x[:, 0])[:, 0]


def init(cfg: MUSIQConfig, generator: torch.Generator,
         device: torch.device | str = "cuda",
         dtype: torch.dtype = torch.float32) -> MUSIQ:
    """A MUSIQ with random weights drawn (on `device`, in `dtype`) from the
    JAX `init` distributions with `generator` (which must live there)."""
    return build_random(lambda: MUSIQ(cfg), generator, device, dtype)


# --------------------------------------------------------------------------- #
# multi-scale patchification (host numpy: ragged per-image shapes)           #
# --------------------------------------------------------------------------- #
def _resize_longer(img: np.ndarray, longer: int) -> np.ndarray:
    """(H, W, 3) float → aspect-preserving bilinear resize (antialiased),
    longer side = `longer`, up or down."""
    h, w = img.shape[:2]
    scale = longer / max(h, w)
    nh, nw = max(round(h * scale), 1), max(round(w * scale), 1)
    return resize(torch.from_numpy(img), (nh, nw, 3), "bilinear").numpy()


def _patchify(img: np.ndarray, cfg: MUSIQConfig):
    """(H, W, 3) → (n_patches, patch_dim), grid (gh, gw); zero-padded to a
    multiple of the patch size (right / bottom)."""
    p = cfg.patch_size
    h, w = img.shape[:2]
    gh, gw = -(-h // p), -(-w // p)
    pad = np.zeros((gh * p, gw * p, 3), np.float32)
    pad[:h, :w] = img
    x = pad.reshape(gh, p, gw, p, 3).transpose(0, 2, 1, 3, 4)
    return x.reshape(gh * gw, p * p * 3), (gh, gw)


def _hse_ids(gh: int, gw: int, g: int) -> np.ndarray:
    """(gh·gw, 2) hash-grid cell per patch: ⌊i·G/gh⌋, ⌊j·G/gw⌋."""
    ii = np.minimum((np.arange(gh) * g) // gh, g - 1)
    jj = np.minimum((np.arange(gw) * g) // gw, g - 1)
    return np.stack(np.meshgrid(ii, jj, indexing="ij"), -1).reshape(-1, 2)


def multiscale_tokens(image01: np.ndarray, cfg: MUSIQConfig = MUSIQConfig()):
    """(H, W, 3) in [0, 1] → (patches (N, patch_dim), hse_ids (N, 2),
    scale_ids (N,), all numpy).  Scale 0 is the native image, scales 1..
    the longer-side resizes."""
    img = np.asarray(image01, np.float32)
    scales = [img] + [_resize_longer(img, s) for s in cfg.longer_sides]
    pats, hse, sid = [], [], []
    for s_idx, s_img in enumerate(scales):
        pk, (gh, gw) = _patchify(s_img, cfg)
        pats.append(pk)
        hse.append(_hse_ids(gh, gw, cfg.hse_grid))
        sid.append(np.full((pk.shape[0],), s_idx, np.int32))
    return (np.concatenate(pats, 0), np.concatenate(hse, 0),
            np.concatenate(sid, 0))


def preprocess_frame(frame: np.ndarray, cfg: MUSIQConfig) -> np.ndarray:
    """uint8 (H, W, 3) → [0, 1] float; 'shorter' mode: if the shorter side
    exceeds 512, a bilinear downscale by 512/shorter without antialiasing
    (torchvision `Resize(antialias=False)`, `imaging_quality.py:14-19`),
    no crop."""
    img = np.asarray(frame, np.float32) / 255.0
    h, w = img.shape[:2]
    if min(h, w) > cfg.max_native_side:
        s = cfg.max_native_side / min(h, w)
        nh, nw = int(s * h), int(s * w)
        img = resize(torch.from_numpy(img), (nh, nw, 3), "bilinear",
                     antialias=False).numpy()
    return img


def make_musiq_scorer(model: MUSIQ):
    """fn(frames) -> float for the gen-eval harness: per-frame MUSIQ MOS,
    averaged, /100 (`imaging_quality.py:32-42`).  Frames are scored one at
    a time (token counts are ragged across frame sizes), each padded to a
    multiple of 64 tokens."""
    cfg = model.cfg
    device = model.cls.device

    def score(frames) -> float:
        vals = []
        for f in frames:
            img = preprocess_frame(f, cfg)
            pk, hid, sid = multiscale_tokens(img, cfg)
            n = pk.shape[0]
            n_pad = -(-n // 64) * 64
            mask = np.zeros((n_pad,), bool)
            mask[:n] = True
            pk = np.pad(pk, ((0, n_pad - n), (0, 0)))
            hid = np.pad(hid, ((0, n_pad - n), (0, 0)))
            sid = np.pad(sid, (0, n_pad - n))
            with torch.no_grad():
                mos = model(*(torch.from_numpy(a[None]).to(device)
                              for a in (pk, hid, sid, mask)))
            vals.append(float(mos[0]))
        return float(np.mean(vals) / 100.0)

    return score


# --------------------------------------------------------------------------- #
# weight IO (the JAX package's npz layout)                                    #
# --------------------------------------------------------------------------- #
def _layout(model: MUSIQ) -> dict:
    """npz key → (the module's tensor, whether the file holds it
    transposed: linear weights are (in, out) there)."""
    out = {}

    def lin(key, m):
        out[f"{key}/w"] = (m.weight, True)
        out[f"{key}/b"] = (m.bias, False)

    def ln(key, m):
        out[f"{key}/scale"] = (m.weight, False)
        out[f"{key}/bias"] = (m.bias, False)

    lin("patch_proj", model.patch_proj)
    for name in ("cls", "hse", "scale_embed"):
        out[name] = (getattr(model, name), False)
    for i, blk in enumerate(model.blocks):
        for name in ("ln1", "ln2"):
            ln(f"blocks/{i}/{name}", getattr(blk, name))
        for name in ("qkv", "proj", "fc1", "fc2"):
            lin(f"blocks/{i}/{name}", getattr(blk, name))
    ln("ln_out", model.ln_out)
    lin("head", model.head)
    return out


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def params_tree(model: MUSIQ) -> dict:
    """The module's weights as the flat {npz key: numpy array} of the JAX
    package's file layout."""
    return {k: (t.detach().T if tr else t.detach()).float().cpu().numpy()
            for k, (t, tr) in _layout(model).items()}


def save_musiq_npz(path, params) -> None:
    """params: a parameter tree in the JAX layout (nested, as
    `musiq_convert.convert_state_dict` returns it) or its flat form."""
    np.savez(path, **_flatten(params))


def load_musiq_npz(path, cfg: MUSIQConfig = MUSIQConfig(), *,
                   device: torch.device | str = "cuda") -> MUSIQ:
    """A flat npz (keys like "blocks/3/qkv/w") → an fp32 MUSIQ on
    `device`, every key and shape validated against `cfg` first."""
    flat = dict(np.load(path))
    with torch.device("meta"):
        skeleton = MUSIQ(cfg)
    ref = {k: tuple(t.shape[::-1]) if tr else tuple(t.shape)
           for k, (t, tr) in _layout(skeleton).items()}
    missing = set(ref) - set(flat)
    extra = set(flat) - set(ref)
    if missing or extra:
        raise ValueError(f"MUSIQ npz mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    for k, v in flat.items():
        if v.shape != ref[k]:
            raise ValueError(f"MUSIQ npz: {k} has shape {v.shape}, "
                             f"expected {ref[k]}")
    model = skeleton.float().to_empty(device=device)
    with torch.no_grad():
        for k, (t, tr) in _layout(model).items():
            v = torch.from_numpy(flat[k])
            t.copy_(v.T if tr else v)
    return model.eval().requires_grad_(False)
