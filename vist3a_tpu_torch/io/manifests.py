"""Expected-key manifests of the reference checkpoints the importers take.

Port of `vist3a_tpu/io/manifests.py`.  `manifests/*.txt` are copies of the
JAX package's committed manifests (one `key  shape` line each, the shape a
tuple or `('size', n)` where only the element count is layout-stable).

  * `load_manifest(family)` parses a manifest;
  * `validate_state_dict(sd, family)` fails loudly, listing every missing,
    unconsumed (beyond the family's documented ignore patterns) and
    mis-shaped key, before an import (VGGT-1B's point head in the AnySplat
    file is optional, and checked whole where present: the manifest, a
    copy of the JAX package's, lacks it);
  * `validate_wan_dit(sd)` picks the DiT manifest by the file's depth;
  * `fabricate_from(manifest)` is a zeros state dict of those keys and
    shapes (broadcast views, free at any size);
  * the fabricators `_fab_anysplat_encoder`, `_fab_wan_vae`, `_fab_wan_dit`,
    `_fab_umt5`, `_fab_hf_clip_model` and `_fab_dfn5b` invert the importers over
    the port's modules: given a module (for the scorers, a `CLIPVision` and
    a `CLIPText`), each returns the reference-named state dict holding
    that module's values (the reference's own shapes for the size-only
    keys); `_fab_hf_clip_vision`, `_fab_hf_clip_text` and `_fab_open_clip`
    are their per-tower pieces; `_fab_hf_clip_model` writes an HF
    CLIPModel (PickScore's layout, and the generation evaluation's CLIP-L
    and LongCLIP-L) and `_fab_qwen_vl` the Qwen2.5-VL judge's HF state
    dict under either key prefix;
  * `expected_keys(family)` is that inversion over the family's deployed
    config built on the meta device, so it costs nothing, as
    `jax.eval_shape` costs nothing there.
"""

from __future__ import annotations

import ast
import math
import re
from pathlib import Path

import torch
from torch import nn

from vist3a_tpu_torch.io import weight_import as wi
from vist3a_tpu_torch.nn import clip as clip_mod
from vist3a_tpu_torch.nn import qwen_vl
from vist3a_tpu_torch.nn import umt5 as umt5_mod
from vist3a_tpu_torch.nn import wan_dit, wan_vae
from vist3a_tpu_torch.nn.encoder import EncoderConfig

MANIFEST_DIR = Path(__file__).resolve().parent / "manifests"


def _fab_anysplat_encoder(encoder: nn.Module, prefix: str = "encoder."
                          ) -> dict[str, torch.Tensor]:
    """An `Encoder` built with vit_start=0 → the AnySplat hub state dict.
    The port holds no DINOv2 mask token, so it is written as zeros (1, D),
    the reference's shape."""
    out = {prefix + wi.encoder_to_reference(k): v
           for k, v in encoder.state_dict().items()}
    d = encoder.vit.cls_token.shape[-1]
    out[prefix + wi.encoder_to_reference(wi.MASK_TOKEN)] = torch.zeros(
        1, d, device=encoder.vit.cls_token.device)
    return out


def _fab_wan_vae(encoder: nn.Module, decoder: nn.Module
                 ) -> dict[str, torch.Tensor]:
    """`WanVAEEncoder` and `WanVAEDecoder` → the `AutoencoderKLWan` state
    dict; the RMS gammas in diffusers' broadcast shapes, (C, 1, 1) in the
    attention blocks and (C, 1, 1, 1) elsewhere."""
    out = {}
    for half in (encoder, decoder):
        for k, v in half.state_dict().items():
            ref = wi.vae_to_reference(k)
            if wi.VAE_BY_SIZE.search(ref):
                v = v.reshape(-1, 1, 1) if ".attentions." in ref \
                    else v.reshape(-1, 1, 1, 1)
            out[ref] = v
    return out


def _fab_wan_dit(dit: nn.Module, prefix: str = ""
                 ) -> dict[str, torch.Tensor]:
    """`WanDiT` → the `WanTransformer3DModel` state dict, the scale-shift
    tables (6, D) and (2, D) as (1, 6, D) and (1, 2, D).  With `prefix`
    (`blocks.<i>.`), `dit` is that part of a DiT (a `WanBlock`)."""
    out = {}
    for k, v in dit.state_dict().items():
        ref = wi.dit_to_reference(prefix + k)
        out[ref] = v[None] if wi.DIT_BY_SIZE.search(ref) else v
    return out


def _fab_umt5(umt5: nn.Module) -> dict[str, torch.Tensor]:
    """`UMT5Encoder` → the `UMT5EncoderModel` state dict."""
    return {wi.umt5_to_reference(k): v for k, v in umt5.state_dict().items()}


_HF_CLIP_LAYER = (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                  ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"),
                  ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                  ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"))
_OPEN_CLIP_LAYER = (("o", "attn.out_proj"), ("ln1", "ln_1"), ("ln2", "ln_2"),
                    ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj"))


def _hf_clip_layers(tower: nn.Module, prefix: str) -> dict:
    out = {}
    for i, layer in enumerate(tower.layers):
        for ours, theirs in _HF_CLIP_LAYER:
            m = getattr(layer, ours)
            out[f"{prefix}.{i}.{theirs}.weight"] = m.weight.detach()
            out[f"{prefix}.{i}.{theirs}.bias"] = m.bias.detach()
    return out


def _fab_hf_clip_vision(vision: clip_mod.CLIPVision) -> dict:
    """`CLIPVision` → HF `CLIPModel`'s vision keys (the pre-LN under HF's
    historical spelling `pre_layrnorm`)."""
    v = "vision_model"
    return {
        f"{v}.embeddings.patch_embedding.weight": vision.patch.detach(),
        f"{v}.embeddings.class_embedding": vision.class_embedding.detach(),
        f"{v}.embeddings.position_embedding.weight":
            vision.pos_embed.detach(),
        f"{v}.pre_layrnorm.weight": vision.ln_pre.weight.detach(),
        f"{v}.pre_layrnorm.bias": vision.ln_pre.bias.detach(),
        **_hf_clip_layers(vision, f"{v}.encoder.layers"),
        f"{v}.post_layernorm.weight": vision.ln_post.weight.detach(),
        f"{v}.post_layernorm.bias": vision.ln_post.bias.detach(),
        "visual_projection.weight": vision.proj.detach().T.contiguous(),
    }


def _fab_hf_clip_text(text: clip_mod.CLIPText) -> dict:
    """`CLIPText` → HF `CLIPModel`'s text keys."""
    t = "text_model"
    return {
        f"{t}.embeddings.token_embedding.weight": text.token_embed.detach(),
        f"{t}.embeddings.position_embedding.weight": text.pos_embed.detach(),
        **_hf_clip_layers(text, f"{t}.encoder.layers"),
        f"{t}.final_layer_norm.weight": text.ln_final.weight.detach(),
        f"{t}.final_layer_norm.bias": text.ln_final.bias.detach(),
        "text_projection.weight": text.proj.detach().T.contiguous(),
    }


def _fab_open_clip(tower: nn.Module, visual: bool) -> dict:
    """A `CLIPVision` (visual=True, prefix 'visual.') or a `CLIPText`
    (unprefixed) → open_clip's keys, q/k/v stacked into `in_proj`."""
    p0 = "visual." if visual else ""
    out = {}
    for i, layer in enumerate(tower.layers):
        p = f"{p0}transformer.resblocks.{i}"
        out[f"{p}.attn.in_proj_weight"] = torch.cat(
            [getattr(layer, n).weight.detach() for n in "qkv"])
        out[f"{p}.attn.in_proj_bias"] = torch.cat(
            [getattr(layer, n).bias.detach() for n in "qkv"])
        for ours, theirs in _OPEN_CLIP_LAYER:
            m = getattr(layer, ours)
            out[f"{p}.{theirs}.weight"] = m.weight.detach()
            out[f"{p}.{theirs}.bias"] = m.bias.detach()
    if visual:
        out.update({
            "visual.conv1.weight": tower.patch.detach(),
            "visual.class_embedding": tower.class_embedding.detach(),
            "visual.positional_embedding": tower.pos_embed.detach(),
            "visual.ln_pre.weight": tower.ln_pre.weight.detach(),
            "visual.ln_pre.bias": tower.ln_pre.bias.detach(),
            "visual.ln_post.weight": tower.ln_post.weight.detach(),
            "visual.ln_post.bias": tower.ln_post.bias.detach(),
            "visual.proj": tower.proj.detach()})
    else:
        out.update({
            "token_embedding.weight": tower.token_embed.detach(),
            "positional_embedding": tower.pos_embed.detach(),
            "ln_final.weight": tower.ln_final.weight.detach(),
            "ln_final.bias": tower.ln_final.bias.detach(),
            "text_projection": tower.proj.detach()})
    return out


def _fab_hf_clip_model(vision: clip_mod.CLIPVision, text: clip_mod.CLIPText,
                       logit_scale: torch.Tensor) -> dict:
    """An HF `CLIPModel`: both towers, both projections and `logit_scale`
    (the log of the logits' scale).  PickScore_v1 (HF CLIP-H; the reward
    multiplies by the scale, `utils/reward.py:159-161`) and the generation
    evaluation's CLIP-L / LongCLIP-L are such files."""
    return {**_fab_hf_clip_vision(vision), **_fab_hf_clip_text(text),
            "logit_scale": logit_scale}



def _fab_dfn5b(vision: clip_mod.CLIPVision, text: clip_mod.CLIPText) -> dict:
    """DFN5B-CLIP-ViT-H-14-378 (open_clip): both towers."""
    return {**_fab_open_clip(vision, True), **_fab_open_clip(text, False)}


def _fab_qwen_vl(vision: qwen_vl.QwenVLVision, text: qwen_vl.QwenVLText, *,
                 legacy: bool = False) -> dict:
    """`QwenVLVision` and `QwenVLText` → HF
    `Qwen2_5_VLForConditionalGeneration`'s state dict under the prefixes
    `model.visual.` / `model.language_model.` (transformers ≥ 4.52), or
    with `legacy` `visual.` / `model.`: the inverse of
    `qwen_vl.import_hf_qwen_vl` (the patch embed as the conv3d weight
    (D, C, tp, ps, ps))."""
    vp, tp = ("visual.", "model.") if legacy else (
        "model.visual.", "model.language_model.")
    vcfg = vision.cfg
    out = {f"{vp}patch_embed.proj.weight": vision.patch_embed.detach().reshape(
        vcfg.hidden_size, vcfg.in_channels, vcfg.temporal_patch_size,
        vcfg.patch_size, vcfg.patch_size)}

    def lin(ours, theirs):
        out[f"{theirs}.weight"] = ours.weight.detach()
        if ours.bias is not None:
            out[f"{theirs}.bias"] = ours.bias.detach()

    for i, blk in enumerate(vision.blocks):
        b = f"{vp}blocks.{i}"
        out[f"{b}.norm1.weight"] = blk.norm1.detach()
        out[f"{b}.norm2.weight"] = blk.norm2.detach()
        lin(blk.qkv, f"{b}.attn.qkv")
        lin(blk.proj, f"{b}.attn.proj")
        for name in ("gate", "up", "down"):
            lin(getattr(blk.mlp, name), f"{b}.mlp.{name}_proj")
    out[f"{vp}merger.ln_q.weight"] = vision.merger.ln_q.detach()
    lin(vision.merger.fc1, f"{vp}merger.mlp.0")
    lin(vision.merger.fc2, f"{vp}merger.mlp.2")
    out[f"{tp}embed_tokens.weight"] = text.embed.detach()
    out[f"{tp}norm.weight"] = text.ln_f.detach()
    for i, layer in enumerate(text.layers):
        b = f"{tp}layers.{i}"
        out[f"{b}.input_layernorm.weight"] = layer.ln1.detach()
        out[f"{b}.post_attention_layernorm.weight"] = layer.ln2.detach()
        for name in "qkvo":
            lin(getattr(layer, name), f"{b}.self_attn.{name}_proj")
        for name in ("gate", "up", "down"):
            lin(getattr(layer.mlp, name), f"{b}.mlp.{name}_proj")
    if text.lm_head is not None:
        out["lm_head.weight"] = text.lm_head.detach()
    return out


def _deployed_scorer(family: str) -> dict:
    vision_cfg = (clip_mod.CLIP_H_224 if family == "pickscore"
                  else clip_mod.DFN5B_H_378)
    vision = wi.on_meta(lambda: clip_mod.CLIPVision(vision_cfg))
    text = wi.on_meta(lambda: clip_mod.CLIPText(clip_mod.CLIP_H_TEXT))
    if family == "pickscore":
        return _fab_hf_clip_model(vision, text,
                                  torch.empty((), device="meta"))
    return _fab_dfn5b(vision, text)


def _deployed_vae():
    cfg = wan_vae.WanVAEConfig()
    return _fab_wan_vae(wi.on_meta(lambda: wan_vae.WanVAEEncoder(cfg)),
                        wi.on_meta(lambda: wan_vae.WanVAEDecoder(cfg)))


# family → (fabricator over the deployed config on the meta device, the
# ignore patterns of unconsumed keys the loader skips on purpose, the keys
# whose manifest entry is a size)
FAMILIES = {
    "anysplat_encoder": {
        "fab": lambda: _fab_anysplat_encoder(
            wi.encoder_skeleton(EncoderConfig())),
        # the hub file also holds the splatting decoder and (in files
        # derived from VGGT-1B) the unused track head
        "ignore": wi.ANYSPLAT_IGNORE,
        "size": None,
        # VGGT-1B's point head, checked whole where a file has any of it
        "optional": ((r"^encoder\.point_head\.", lambda: {
            k: tuple(v.shape) for k, v in _fab_anysplat_encoder(
                wi.encoder_skeleton(EncoderConfig(pred_head_type="point")))
            .items() if k.startswith("encoder.point_head.")}),),
    },
    "wan_vae": {"fab": _deployed_vae, "ignore": (), "size": wi.VAE_BY_SIZE},
    "wan_dit_1_3b": {
        "fab": lambda: _fab_wan_dit(wi.on_meta(lambda: wan_dit.WanDiT(
            wan_dit.WAN_1_3B))),
        "ignore": (), "size": wi.DIT_BY_SIZE},
    "wan_dit_14b": {
        "fab": lambda: _fab_wan_dit(wi.on_meta(lambda: wan_dit.WanDiT(
            wan_dit.WAN_14B))),
        "ignore": (), "size": wi.DIT_BY_SIZE},
    "umt5_xxl": {
        "fab": lambda: _fab_umt5(wi.on_meta(lambda: umt5_mod.UMT5Encoder(
            umt5_mod.UMT5_XXL))),
        # the tied copy of the shared embedding
        "ignore": (r"^encoder\.embed_tokens\.weight$",), "size": None},
    "pickscore": {
        "fab": lambda: _deployed_scorer("pickscore"),
        # HF CLIPModel buffers and the other spelling of the pre-LN
        "ignore": (r"\.position_ids$", r"^vision_model\.pre_layernorm\."),
        # HF's class embedding is (D,) or (1, 1, D) by version; logit_scale
        # () or (1,)
        "size": re.compile(r"(class_embedding|^logit_scale)$")},
    "dfn5b": {"fab": lambda: _deployed_scorer("dfn5b"),
              "ignore": (r"^logit_scale$", r"^logit_bias$"), "size": None},
}


def expected_keys(family: str) -> dict:
    """key → shape tuple, or ("size", n) where only the element count is
    layout-stable: the fabricator's inversion of the deployed config."""
    spec = FAMILIES[family]
    size = spec["size"]
    return {k: ("size", v.numel()) if size is not None and size.search(k)
            else tuple(v.shape) for k, v in spec["fab"]().items()}


def load_manifest(family: str) -> dict:
    """The committed `manifests/<family>.txt` as key → spec."""
    out = {}
    for line in (MANIFEST_DIR / f"{family}.txt").read_text().splitlines():
        if line.strip():
            k, spec = line.split("  ", 1)
            out[k] = ast.literal_eval(spec)
    return out


def validate_state_dict(sd: dict, family: str) -> bool:
    """Raise ValueError listing every key of the family's manifest that
    `sd` misses, every key of `sd` outside it and its ignore patterns, and
    every shape (or, for size entries, element count) that differs.  A
    family's optional part (the AnySplat file's point head) joins the
    manifest where `sd` has a key of it."""
    exp = load_manifest(family)
    for pattern, part in FAMILIES[family].get("optional", ()):
        if any(re.search(pattern, k) for k in sd):
            exp.update(part())
    ignore = [re.compile(p) for p in FAMILIES[family]["ignore"]]
    missing = sorted(k for k in exp if k not in sd)
    extra = sorted(k for k in sd if k not in exp
                   and not any(p.search(k) for p in ignore))
    bad_shape = []
    for k, spec in exp.items():
        if k not in sd:
            continue
        got = tuple(sd[k].shape)
        n = math.prod(got)
        if spec and spec[0] == "size":
            if n != spec[1]:
                bad_shape.append(f"{k}: size {n} != {spec[1]}")
        elif got != tuple(spec):
            bad_shape.append(f"{k}: {got} != {tuple(spec)}")
    problems = []
    if missing:
        problems.append(f"{len(missing)} missing keys, first 20:\n  "
                        + "\n  ".join(missing[:20]))
    if extra:
        problems.append(f"{len(extra)} unconsumed keys, first 20:\n  "
                        + "\n  ".join(extra[:20]))
    if bad_shape:
        problems.append(f"{len(bad_shape)} shape mismatches, first 20:\n  "
                        + "\n  ".join(bad_shape[:20]))
    if problems:
        raise ValueError(
            f"checkpoint does not match the '{family}' manifest "
            f"(vist3a_tpu_torch/io/manifests/{family}.txt):\n"
            + "\n".join(problems))
    return True


def validate_wan_dit(sd: dict) -> dict:
    """The DiT manifest of the file's own depth (the CLI takes either
    released size, `--model_id`)."""
    validate_state_dict(sd, "wan_dit_14b" if wi.dit_depth(sd) == 40
                        else "wan_dit_1_3b")
    return sd


def fabricate_from(exp: dict) -> dict[str, torch.Tensor]:
    """A zeros state dict of exactly `exp`'s keys and shapes (a size entry
    as a flat vector), made of broadcast views: nothing is allocated."""
    out = {}
    for k, spec in exp.items():
        shape = (spec[1],) if spec and spec[0] == "size" else tuple(spec)
        out[k] = torch.zeros(()).expand(shape)
    return out
