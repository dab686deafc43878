"""Expected-key manifests of the reference checkpoints the importers take.

Port of `vist3a_tpu/io/manifests.py`.  `manifests/*.txt` are copies of the
JAX package's committed manifests (one `key  shape` line each, the shape a
tuple or `('size', n)` where only the element count is layout-stable).

  * `load_manifest(family)` parses a manifest;
  * `validate_state_dict(sd, family)` fails loudly, listing every missing,
    unconsumed (beyond the family's documented ignore patterns) and
    mis-shaped key, before an import;
  * `validate_wan_dit(sd)` picks the DiT manifest by the file's depth;
  * `fabricate_from(manifest)` is a zeros state dict of those keys and
    shapes (broadcast views, free at any size);
  * the fabricators `_fab_anysplat_encoder`, `_fab_wan_vae`, `_fab_wan_dit`
    and `_fab_umt5` invert the importers over the port's modules: given a
    module, each returns the reference-named state dict holding that
    module's values (the reference's own shapes for the size-only keys);
  * `expected_keys(family)` is that inversion over the family's deployed
    config built on the meta device, so it costs nothing, as
    `jax.eval_shape` costs nothing there.

The CLIP families (`pickscore`, `dfn5b`) can be validated; their
fabricators wait for the port's CLIP text towers.
"""

from __future__ import annotations

import ast
import math
import re
from pathlib import Path

import torch
from torch import nn

from vist3a_tpu_torch.io import weight_import as wi
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


def _fab_wan_dit(dit: nn.Module) -> dict[str, torch.Tensor]:
    """`WanDiT` → the `WanTransformer3DModel` state dict, the scale-shift
    tables (6, D) and (2, D) as (1, 6, D) and (1, 2, D)."""
    out = {}
    for k, v in dit.state_dict().items():
        ref = wi.dit_to_reference(k)
        out[ref] = v[None] if wi.DIT_BY_SIZE.search(ref) else v
    return out


def _fab_umt5(umt5: nn.Module) -> dict[str, torch.Tensor]:
    """`UMT5Encoder` → the `UMT5EncoderModel` state dict."""
    return {wi.umt5_to_reference(k): v for k, v in umt5.state_dict().items()}


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
        "fab": None,
        # HF CLIPModel buffers and the other spelling of the pre-LN
        "ignore": (r"\.position_ids$", r"^vision_model\.pre_layernorm\."),
        "size": None},
    "dfn5b": {"fab": None, "ignore": (r"^logit_scale$", r"^logit_bias$"),
              "size": None},
}


def expected_keys(family: str) -> dict:
    """key → shape tuple, or ("size", n) where only the element count is
    layout-stable: the fabricator's inversion of the deployed config."""
    spec = FAMILIES[family]
    if spec["fab"] is None:
        raise NotImplementedError(
            f"{family}: the fabricator waits for the CLIP text towers "
            "(ROADMAP Queue 1, item 15); validate against load_manifest")
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
    every shape (or, for size entries, element count) that differs."""
    exp = load_manifest(family)
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
