"""Reference state dicts → state dicts of the port's modules.

Port of `vist3a_tpu/io/weight_import.py`.  The reference checkpoints are
torch state dicts (the AnySplat hub file, `anysplat_stitched.pth`, the Wan
diffusers VAE and DiT, HF UMT5, PEFT LoRA folders) and the port keeps torch
layouts, so an import is a rename.  The places where it is more:

  * RMS gammas (the Wan VAE's `(C, 1, 1[, 1])`) and the DiT's
    `scale_shift_table`s (`(1, 6, D)`, `(1, 2, D)`) are reshaped to the
    module's parameter by element count, as the manifests give them only as
    `("size", n)`;
  * the DINOv2 `mask_token` of the AnySplat file is read and dropped: no
    forward of the port reads it (`nn/vit.py`);
  * UMT5's `encoder.embed_tokens.weight` is the tied copy of
    `shared.weight` and is ignored when that is present;
  * `apply_peft_lora` merges a PEFT adapter into the imported DiT in fp32,
    before any cast to the module's dtype, as the JAX package does;
  * `import_stitched_checkpoint` maps the LoRA factors of the stitched
    checkpoint onto the port's sites, the DPT head renames included, and
    shifts the ViT block index by the chop (saved block i is block k + i of
    the whole trunk).

Each `<family>_to_reference` / `<family>_from_reference` pair spells one
family's names in the two directions: `io/manifests.py` inverts the port's
modules with the first, the importers read with the second, and the tests
hold both against the committed manifests.  An importer returns the state
dict of the port's module built from `cfg` (on the meta device, so it costs
nothing), its tensors those of `sd` in the file's dtype; it raises on a
reference key it does not consume, a module parameter it leaves unset and
a shape that does not fit, each listed.  `module.load_state_dict(out,
strict=True)` then casts where it copies.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable

import torch
from torch import nn

from vist3a_tpu_torch.nn import umt5 as umt5_mod
from vist3a_tpu_torch.nn import wan_dit, wan_vae
from vist3a_tpu_torch.nn.encoder import Encoder, EncoderConfig

Rules = tuple[tuple[str, object], ...]


def _sub_first(name: str, rules: Rules) -> str | None:
    """`name` rewritten by the first rule whose pattern matches it, or None
    when none does."""
    for pattern, repl in rules:
        new, n = re.subn(pattern, repl, name, count=1)
        if n:
            return new
    return None


def on_meta(factory: Callable[[], nn.Module]) -> nn.Module:
    """`factory()` built on the meta device: names and shapes, no storage."""
    with torch.device("meta"):
        return factory()


def _problems(family: str, unconsumed, missing, bad) -> None:
    problems = []
    for what, keys in (("reference keys not consumed", unconsumed),
                       ("module parameters left unset", missing),
                       ("shapes that do not fit", bad)):
        if keys:
            problems.append(f"{len(keys)} {what}, first 20:\n  "
                            + "\n  ".join(sorted(keys)[:20]))
    if problems:
        raise KeyError(f"{family}: the state dict does not import into the "
                       "port's module:\n" + "\n".join(problems))


def _import(sd: dict, own: dict[str, torch.Tensor], from_reference,
            family: str, *, ignore: tuple = (), dropped: tuple = (),
            by_size=None) -> dict[str, torch.Tensor]:
    """{port name: tensor of sd} for the module whose state dict is `own`.
    Keys matching an `ignore` pattern are skipped; keys renamed to one of
    `dropped` are consumed and left out; where `by_size` accepts a
    reference key, the tensor is reshaped to the module's parameter by
    element count."""
    ignore = [re.compile(p) for p in ignore]
    out, unconsumed, bad = {}, [], []
    for key, value in sd.items():
        if any(p.search(key) for p in ignore):
            continue
        name = from_reference(key)
        if name in dropped:
            continue
        if name not in own or name in out:
            unconsumed.append(key)
            continue
        want = own[name].shape
        if value.shape != want:
            if (by_size is not None and by_size(key)
                    and value.numel() == math.prod(want)):
                value = value.reshape(want)
            else:
                bad.append(f"{key}: {tuple(value.shape)}, the module's "
                           f"{name} is {tuple(want)}")
                continue
        out[name] = value
    _problems(family, unconsumed, [n for n in own if n not in out], bad)
    return out


def build_module(factory: Callable[[], nn.Module], state: dict, *,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """`factory()` built on the meta device, cast to `dtype`, given
    uninitialised storage on `device` and filled from `state`, strictly
    (the copy casts to the module's dtype); in eval mode, frozen."""
    model = on_meta(factory).to(dtype).to_empty(device=device)
    with torch.no_grad():
        model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)


# --------------------------------------------------------------------------- #
# VGGT / AnySplat encoder                                                     #
# --------------------------------------------------------------------------- #
_ENC_TO_REF: Rules = (
    (r"^vit\.patch_proj\.", "aggregator.patch_embed.patch_embed.proj."),
    (r"^vit\.", "aggregator.patch_embed."),
    (r"^aggregator\.", "aggregator."),
    (r"^camera_head\.modulation\.", "camera_head.poseLN_modulation.1."),
    (r"^camera_head\.", "camera_head."),
    (r"^depth_head\.", "depth_head."),
    (r"^point_head\.", "point_head."),
    (r"^gs_head\.", "gaussian_param_head."),
)
_ENC_FROM_REF: Rules = (
    (r"^aggregator\.patch_embed\.patch_embed\.proj\.", "vit.patch_proj."),
    (r"^aggregator\.patch_embed\.", "vit."),
    (r"^aggregator\.", "aggregator."),
    (r"^camera_head\.poseLN_modulation\.1\.", "camera_head.modulation."),
    (r"^camera_head\.", "camera_head."),
    (r"^depth_head\.", "depth_head."),
    (r"^point_head\.", "point_head."),
    (r"^gaussian_param_head\.", "gs_head."),
)
# inside a DPT / GS head: the port's module names (the JAX tree's) and the
# reference's (`vggt/heads/dpt_head.py`: `scratch.*`, `resize_layers.*`,
# `output_conv2` a Sequential with the activation at index 1)
_HEAD_TO_REF: Rules = (
    (r"^resize([013])\.", r"resize_layers.\1."),
    (r"^layer_rn\.(\d)\.", lambda m: f"scratch.layer{int(m[1]) + 1}_rn."),
    (r"^refinenet(\d)\.res(\d)\.", r"scratch.refinenet\1.resConfUnit\2."),
    (r"^refinenet(\d)\.out_conv\.", r"scratch.refinenet\1.out_conv."),
    (r"^output_conv1\.", "scratch.output_conv1."),
    (r"^output_conv2\.0\.", "scratch.output_conv2.0."),
    (r"^output_conv2\.1\.", "scratch.output_conv2.2."),
    (r"^input_merger\.", "input_merger.0."),
)
_HEAD_FROM_REF: Rules = (
    (r"^resize_layers\.([013])\.", r"resize\1."),
    (r"^scratch\.layer(\d)_rn\.", lambda m: f"layer_rn.{int(m[1]) - 1}."),
    (r"^scratch\.refinenet(\d)\.resConfUnit(\d)\.", r"refinenet\1.res\2."),
    (r"^scratch\.refinenet(\d)\.out_conv\.", r"refinenet\1.out_conv."),
    (r"^scratch\.output_conv1\.", "output_conv1."),
    (r"^scratch\.output_conv2\.0\.", "output_conv2.0."),
    (r"^scratch\.output_conv2\.2\.", "output_conv2.1."),
    (r"^input_merger\.0\.", "input_merger."),
)
_HEAD_PREFIX = re.compile(
    r"^(depth_head|point_head|gs_head|gaussian_param_head)\.")
_VIT_BLOCK = re.compile(r"^vit\.blocks\.(\d+)\.")
# keys of the AnySplat hub file the port never reads (`io/manifests.py`)
ANYSPLAT_IGNORE = (r"^decoder\.", r"^encoder\.track_head\.",
                   r"\.position_ids$")
MASK_TOKEN = "vit.mask_token"


def _heads(name: str, rules: Rules) -> str:
    m = _HEAD_PREFIX.match(name)
    if m is None:
        return name
    rest = name[m.end():]
    return m.group(0) + (_sub_first(rest, rules) or rest)


def encoder_to_reference(name: str) -> str:
    """An `Encoder` parameter or module name → the reference's, without the
    hub file's `encoder.` prefix."""
    out = _sub_first(name, _ENC_TO_REF)
    if out is None:
        raise KeyError(f"no reference name for the encoder's {name!r}")
    return _heads(out, _HEAD_TO_REF)


def encoder_from_reference(name: str, vit_chop: int = 0) -> str | None:
    """The reference's name (without `encoder.`) → the `Encoder`'s, or None
    for a name outside the encoder.  vit_chop=k: the name is of the
    stitched model, whose ViT block i is block k + i of the whole trunk."""
    out = _sub_first(name, _ENC_FROM_REF)
    if out is None:
        return None
    if vit_chop:
        out = _VIT_BLOCK.sub(lambda m: f"vit.blocks.{int(m[1]) + vit_chop}.",
                             out, count=1)
    return _heads(out, _HEAD_FROM_REF)


def encoder_skeleton(cfg: EncoderConfig = EncoderConfig()) -> Encoder:
    """The whole encoder (the ViT from block 0) on the meta device."""
    return on_meta(lambda: Encoder(cfg, vit_start=0))


def import_anysplat_encoder(sd: dict, cfg: EncoderConfig = EncoderConfig(),
                            prefix: str = "encoder."
                            ) -> dict[str, torch.Tensor]:
    """The AnySplat hub state dict (`lhjiang/anysplat`: `encoder.aggregator.*`,
    `encoder.camera_head.*`, `encoder.depth_head.*`,
    `encoder.gaussian_param_head.*`, and in files derived from VGGT-1B
    `encoder.point_head.*`) → the state dict of `Encoder(cfg,
    vit_start=0)`.  The splatting decoder and the track head are ignored;
    the point head is imported when `cfg.pred_head_type` is "point" (a file
    without one then raises) and skipped otherwise, as the depth path never
    reads it."""
    def from_reference(key):
        return (encoder_from_reference(key[len(prefix):])
                if key.startswith(prefix) else None)

    ignore = ANYSPLAT_IGNORE if cfg.pred_head_type == "point" else \
        (*ANYSPLAT_IGNORE, rf"^{re.escape(prefix)}point_head\.")
    return _import(sd, encoder_skeleton(cfg).state_dict(), from_reference,
                   "anysplat_encoder", ignore=ignore, dropped=(MASK_TOKEN,))


# --------------------------------------------------------------------------- #
# Wan causal-3D VAE (diffusers `AutoencoderKLWan`)                            #
# --------------------------------------------------------------------------- #
_RMS = r"(norm1|norm2|norm|norm_out)"
_VAE_TO_REF: Rules = (
    (rf"\.{_RMS}\.weight$", r".\1.gamma"),
    (r"\.conv\.(weight|bias)$", r".resample.1.\1"),
)
_VAE_FROM_REF: Rules = (
    (rf"\.{_RMS}\.gamma$", r".\1.weight"),
    (r"\.resample\.1\.(weight|bias)$", r".conv.\1"),
)
VAE_BY_SIZE = re.compile(r"\.gamma$")


def vae_to_reference(name: str) -> str:
    return _sub_first(name, _VAE_TO_REF) or name


def vae_from_reference(name: str) -> str:
    return _sub_first(name, _VAE_FROM_REF) or name


def vae_skeletons(cfg: wan_vae.WanVAEConfig = wan_vae.WanVAEConfig()
                  ) -> dict[str, nn.Module]:
    return {"encoder": on_meta(lambda: wan_vae.WanVAEEncoder(cfg)),
            "decoder": on_meta(lambda: wan_vae.WanVAEDecoder(cfg))}


def import_wan_vae(sd: dict, cfg: wan_vae.WanVAEConfig = wan_vae.WanVAEConfig()
                   ) -> dict[str, dict[str, torch.Tensor]]:
    """The whole `AutoencoderKLWan` state dict → {"encoder": state dict of
    `WanVAEEncoder(cfg)`, "decoder": of `WanVAEDecoder(cfg)`}; every key
    of both halves is consumed."""
    halves = {k: m.state_dict() for k, m in vae_skeletons(cfg).items()}
    whole = _import(sd, {**halves["encoder"], **halves["decoder"]},
                    vae_from_reference, "wan_vae",
                    by_size=VAE_BY_SIZE.search)
    return {k: {n: whole[n] for n in own} for k, own in halves.items()}


# --------------------------------------------------------------------------- #
# UMT5 encoder (HF `UMT5EncoderModel`)                                        #
# --------------------------------------------------------------------------- #
_BLOCK = r"encoder\.block\.(\d+)\.layer"
_UMT5_TO_REF: Rules = (
    (r"^embed$", "shared.weight"),
    (r"^final_ln$", "encoder.final_layer_norm.weight"),
    (r"^layers\.(\d+)\.ln1$", r"encoder.block.\1.layer.0.layer_norm.weight"),
    (r"^layers\.(\d+)\.rel_bias$",
     r"encoder.block.\1.layer.0.SelfAttention.relative_attention_bias.weight"),
    (r"^layers\.(\d+)\.([qkvo])\.weight$",
     r"encoder.block.\1.layer.0.SelfAttention.\2.weight"),
    (r"^layers\.(\d+)\.ln2$", r"encoder.block.\1.layer.1.layer_norm.weight"),
    # HF names the gated MLP "DenseReluDense" (wi_0 / wi_1 / wo)
    (r"^layers\.(\d+)\.(wi_0|wi_1|wo)\.weight$",
     r"encoder.block.\1.layer.1.DenseReluDense.\2.weight"),
)
_UMT5_FROM_REF: Rules = (
    (r"^shared\.weight$", "embed"),
    (r"^encoder\.embed_tokens\.weight$", "embed"),
    (r"^encoder\.final_layer_norm\.weight$", "final_ln"),
    (rf"^{_BLOCK}\.0\.layer_norm\.weight$", r"layers.\1.ln1"),
    (rf"^{_BLOCK}\.0\.SelfAttention\.relative_attention_bias\.weight$",
     r"layers.\1.rel_bias"),
    (rf"^{_BLOCK}\.0\.SelfAttention\.([qkvo])\.weight$",
     r"layers.\1.\2.weight"),
    (rf"^{_BLOCK}\.1\.layer_norm\.weight$", r"layers.\1.ln2"),
    (rf"^{_BLOCK}\.1\.(?:DenseReluDense|DenseGatedActDense)\."
     r"(wi_0|wi_1|wo)\.weight$", r"layers.\1.\2.weight"),
)


def umt5_to_reference(name: str) -> str:
    out = _sub_first(name, _UMT5_TO_REF)
    if out is None:
        raise KeyError(f"no reference name for UMT5's {name!r}")
    return out


def umt5_from_reference(name: str) -> str | None:
    return _sub_first(name, _UMT5_FROM_REF)


def import_umt5(sd: dict, cfg: umt5_mod.UMT5Config = umt5_mod.UMT5_XXL
                ) -> dict[str, torch.Tensor]:
    """HF `UMT5EncoderModel` state dict → the state dict of
    `UMT5Encoder(cfg)`; `encoder.embed_tokens.weight`, the tied copy of
    `shared.weight`, is read only when the latter is missing."""
    ignore = (r"^encoder\.embed_tokens\.weight$",) \
        if "shared.weight" in sd else ()
    return _import(sd, on_meta(lambda: umt5_mod.UMT5Encoder(cfg)).state_dict(),
                   umt5_from_reference, "umt5", ignore=ignore)


# --------------------------------------------------------------------------- #
# Wan DiT (diffusers `WanTransformer3DModel`) and its PEFT LoRA               #
# --------------------------------------------------------------------------- #
_COND = "condition_embedder"
_DIT_TO_REF: Rules = (
    (r"^(time|text)_embedder\.fc(\d)\.", rf"{_COND}.\1_embedder.linear_\2."),
    (r"^time_proj\.", f"{_COND}.time_proj."),
    (r"\.(attn\d)\.([qkv])\.", r".\1.to_\2."),
    (r"\.(attn\d)\.o\.", r".\1.to_out.0."),
    (r"\.(attn\d)\.(norm_[qk])$", r".\1.\2.weight"),
    (r"\.ffn\.fc1\.", ".ffn.net.0.proj."),
    (r"\.ffn\.fc2\.", ".ffn.net.2."),
)
_DIT_FROM_REF: Rules = (
    (rf"^{_COND}\.(time|text)_embedder\.linear_(\d)\.", r"\1_embedder.fc\2."),
    (rf"^{_COND}\.time_proj\.", "time_proj."),
    (r"\.(attn\d)\.to_([qkv])\.", r".\1.\2."),
    (r"\.(attn\d)\.to_out\.0\.", r".\1.o."),
    (r"\.(attn\d)\.(norm_[qk])\.weight$", r".\1.\2"),
    (r"\.ffn\.net\.0\.proj\.", ".ffn.fc1."),
    (r"\.ffn\.net\.2\.", ".ffn.fc2."),
)
DIT_BY_SIZE = re.compile(r"scale_shift_table$")
# PEFT module names of the DiT's LoRA sites → the port's (`train_vdm.py:
# 370-388` targets q/k/v/out of both attention blocks)
_PEFT_SITE = re.compile(
    r"^(?:base_model\.model\.)?(blocks\.\d+\.attn\d)\.(to_q|to_k|to_v|"
    r"to_out\.0|to_out)\.lora_([AB])\.weight$")
_PEFT_PROJ = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "o",
              "to_out": "o"}


def dit_to_reference(name: str) -> str:
    return _sub_first(name, _DIT_TO_REF) or name


def dit_from_reference(name: str) -> str:
    return _sub_first(name, _DIT_FROM_REF) or name


def dit_depth(sd: dict) -> int:
    return 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))


def dit_config(sd: dict, cfg: wan_dit.WanDiTConfig | None = None
               ) -> wan_dit.WanDiTConfig:
    """`cfg` with the depth of the file's keys; without `cfg`, the released
    size of that depth (40 layers: 14B, else 1.3B)."""
    depth = dit_depth(sd)
    if cfg is None:
        return wan_dit.WAN_14B if depth == 40 else wan_dit.WAN_1_3B
    return dataclasses.replace(cfg, num_layers=depth)


def import_wan_dit(sd: dict, cfg: wan_dit.WanDiTConfig | None = None
                   ) -> dict[str, torch.Tensor]:
    """diffusers `WanTransformer3DModel` state dict → the state dict of
    `WanDiT(dit_config(sd, cfg))`."""
    cfg = dit_config(sd, cfg)
    return _import(sd, on_meta(lambda: wan_dit.WanDiT(cfg)).state_dict(),
                   dit_from_reference, "wan_dit", by_size=DIT_BY_SIZE.search)


def apply_peft_lora(dit_sd: dict[str, torch.Tensor], lora_sd: dict, *,
                    r: int = 8, alpha: int = 16,
                    dtype: torch.dtype | None = None,
                    device: torch.device | str | None = None
                    ) -> dict[str, torch.Tensor]:
    """A PEFT adapter (`base_model.model.blocks.{i}.attn1.to_q.lora_A.weight`
    (r, in) / `lora_B.weight` (out, r)) merged into an imported DiT state
    dict: each site's weight becomes w + (B @ A)·α/r, computed in fp32
    from the file's values, before any cast (the JAX package merges into
    fp32 numpy), on `device` (by default where the weight is); the other
    entries are `dit_sd`'s own.  With `dtype` (the module's), each merged
    site is cast to it at once, which rounds the same fp32 sum as casting
    them all later, and at 14B the fp32 sites (320 × 5120² × 4 B ≈
    33.5 GB) are never held together.  Keys of the adapter that are no
    factor of a site raise."""
    scaling = alpha / r
    factors: dict[str, dict[str, torch.Tensor]] = {}
    stray = []
    for key, value in lora_sd.items():
        m = _PEFT_SITE.match(key)
        if m is None:
            stray.append(key)
            continue
        site = f"{m[1]}.{_PEFT_PROJ[m[2]]}.weight"
        factors.setdefault(site, {})[m[3]] = value
    unknown = [s for s in factors if s not in dit_sd]
    half = [s for s, f in factors.items() if len(f) != 2]
    _problems("peft_lora", stray + unknown, half, [])
    out = dict(dit_sd)
    for site, f in factors.items():
        w = dit_sd[site]
        dev = w.device if device is None else device
        delta = f["B"].to(dev, torch.float32) @ f["A"].to(dev, torch.float32)
        # moved in the file's dtype, widened where the sum is computed
        merged = w.to(dev).float() + delta * scaling
        out[site] = merged if dtype is None else merged.to(dtype)
    return out


# --------------------------------------------------------------------------- #
# the stitched checkpoint (`model_stitching_training.py:57-72`)               #
# --------------------------------------------------------------------------- #
STITCHED_KEYS = ("lora", "stitching_layer", "mask_token", "cls_token",
                 "register_tokens")
_LORA_LEAF = re.compile(r"^(.*)\.(lora_A|lora_B|bias)$")


def import_stitched_checkpoint(sd: dict, vit_chop: int = 0) -> dict:
    """`stitched_model_epoch_N.pth` → {"stitch_conv": {"weight", "bias"},
    "special": {"mask_token", "cls_token", "register_tokens"}, "lora":
    {"encoder.<site>": {"a", "b"[, "bias"]}}}, the sites named as the
    port's modules (those of a `StitchedDecoder`).

    vit_chop=k, the stitch layer index: the reference deletes the first k
    ViT blocks (`models/anysplat_stitched.py:158-165`), so a saved
    `patch_embed.blocks.{i}` factor belongs to block k + i.  The factors
    keep the JAX layout: a = lora_Aᵀ (in·k, r·k), b = lora_Bᵀ (r·k,
    out·k); a bias (saved under bias="lora_only") rides along as "bias".
    Keys outside that layout raise."""
    stray = [k for k in sd if k not in STITCHED_KEYS]
    missing = [k for k in STITCHED_KEYS if k != "lora" and k not in sd]
    lora: dict[str, dict[str, torch.Tensor]] = {}
    for key, value in sd.get("lora", {}).items():
        m = _LORA_LEAF.match(key)
        site = (encoder_from_reference(m[1][len("encoder."):] + ".", vit_chop)
                if m and m[1].startswith("encoder.") else None)
        if site is None:
            stray.append(f"lora/{key}")
            continue
        leaf = {"lora_A": "a", "lora_B": "b", "bias": "bias"}[m[2]]
        lora.setdefault("encoder." + site[:-1], {})[leaf] = \
            value.T if leaf != "bias" else value
    _problems("stitched_checkpoint", stray, missing, [])
    st = sd["stitching_layer"]
    return {"stitch_conv": {"weight": st["weight"], "bias": st["bias"]},
            "special": {k: sd[k] for k in STITCHED_KEYS[2:]},
            "lora": lora}
