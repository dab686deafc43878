"""Checkpoint files → the port's modules, for the CLI entry points.

Port of `vist3a_tpu/cli/model_loading.py` (the reference's
`nvs_eval.py:21-63` `load_stitching_model` and
`utils/utils_for_thirdparty.py`): the stitched decoder rebuilt from (a) the
pretrained AnySplat encoder, (b) the Wan VAE and (c) the trained stitching
checkpoint {lora, stitching_layer, mask / cls / register tokens}, its trunk
then cast to bf16.  Every file passes its manifest (`io/manifests.py`)
before it is imported, and every import is strict.

The weight files are local paths: `--weights_root` or $VIST3A_WEIGHTS,
laid out as

    {root}/anysplat.pth                # lhjiang/anysplat full state dict
                                       # (or {root}/anysplat/*.safetensors)
    {root}/wan_vae/                    # diffusers AutoencoderKLWan subfolder
    {root}/wan_dit/                    # diffusers WanTransformer3DModel
    {root}/umt5/                       # HF UMT5EncoderModel (+ tokenizer)
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from vist3a_tpu_torch.io import load_weights, manifests
from vist3a_tpu_torch.io import weight_import as wi
from vist3a_tpu_torch.nn.encoder import Encoder, EncoderConfig, cast_trunk_bf16
from vist3a_tpu_torch.nn.wan_vae import (WanVAEConfig, WanVAEDecoder,
                                         WanVAEEncoder)
from vist3a_tpu_torch.stitch import chopped_anysplat as ca
from vist3a_tpu_torch.stitch import lora as lora_mod
from vist3a_tpu_torch.stitch.conv_spec import ConvSpec, conv_spec_to_string


def weights_root(args=None) -> Path:
    root = getattr(args, "weights_root", None) or os.environ.get(
        "VIST3A_WEIGHTS", "checkpoints")
    return Path(root)


def _validate(sd: dict, family: str) -> dict:
    """The manifest gate: a released file that misses, adds or reshapes
    keys fails here with the whole difference, before any import."""
    manifests.validate_state_dict(sd, family)
    return sd


def load_anysplat_encoder(root: Path, cfg: EncoderConfig, *,
                          device: torch.device | str = "cuda") -> Encoder:
    """The pretrained AnySplat encoder, whole (vit_start=0), fp32."""
    p = root / "anysplat.pth"
    sd = (load_weights.load_torch_state_dict(p) if p.exists()
          else load_weights.load_sharded_safetensors(root / "anysplat"))
    state = wi.import_anysplat_encoder(_validate(sd, "anysplat_encoder"), cfg)
    return wi.build_module(lambda: Encoder(cfg, vit_start=0), state,
                           device=device)


def load_wan_vae(root: Path, cfg: WanVAEConfig, *,
                 halves: tuple[str, ...] = ("encoder", "decoder"),
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32) -> dict:
    """{"encoder": WanVAEEncoder, "decoder": WanVAEDecoder} from
    `{root}/wan_vae`, in `dtype`, only the `halves` asked for built (the
    whole file is validated and imported all the same)."""
    sd = load_weights.load_sharded_safetensors(root / "wan_vae")
    state = wi.import_wan_vae(_validate(sd, "wan_vae"), cfg)
    kinds = {"encoder": WanVAEEncoder, "decoder": WanVAEDecoder}
    return {k: wi.build_module(lambda m=kinds[k]: m(cfg), state[k],
                               device=device, dtype=dtype)
            for k in halves}


def stitched_config(args) -> ca.StitchedConfig:
    """`--stitching_layer_location` ("enc_blocks_<k>") and
    `--stitching_layer_config` → StitchedConfig."""
    spec = args.stitching_layer_config
    return ca.StitchedConfig(
        encoder=EncoderConfig(),
        stitch_layer_index=int(
            args.stitching_layer_location.rsplit("_", 1)[-1]),
        conv_spec=(conv_spec_to_string(spec) if isinstance(spec, ConvSpec)
                   else str(spec)))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, torch.float32)


@torch.no_grad()
def load_stitched_model(args, *, eval_dtype_bf16: bool = True,
                        device: torch.device | str = "cuda"):
    """The stitched decoder of `args.checkpoint_path` (a torch
    `stitched_model_epoch_N.pth`) on top of the pretrained encoder, and the
    Wan VAE's decoder (what a request runs; `load_wan_vae` gives both
    halves).  Returns ({"stitched": StitchedDecoder, "vae":
    WanVAEDecoder}, scfg), on `device`.

    The order is the JAX package's: the encoder imported in fp32; the
    checkpoint's bias="lora_only" biases set and its LoRA merged, in fp32;
    the cls and register tokens set (the mask token is read and dropped:
    the port holds none); the trunk cast to bf16 (`eval_dtype_bf16`, the
    VAE too); the stitched decoder built from the result without the
    blocks before the chop."""
    root = weights_root(args)
    scfg = stitched_config(args)
    encoder = load_anysplat_encoder(root, scfg.encoder, device=device)
    dtype = torch.bfloat16 if eval_dtype_bf16 else torch.float32
    vae = load_wan_vae(root, WanVAEConfig(), halves=("decoder",),
                       device=device, dtype=dtype)

    if getattr(args, "checkpoint_path", None):
        sd = load_weights.load_torch_state_dict(args.checkpoint_path)
        pieces = wi.import_stitched_checkpoint(
            sd, vit_chop=scfg.stitch_layer_index)
        flat = {k.removeprefix("encoder."): v
                for k, v in _to(pieces["lora"], device).items()}
        lora, biases = lora_mod.lora_from_flat(flat, encoder)
        params = {**encoder.state_dict(), **biases}
        params = lora_mod.merge_lora(
            params, lora, lora_mod.parse_lora_mode(args.lora_config))
        params["vit.cls_token"] = pieces["special"]["cls_token"]
        params["vit.register_tokens"] = pieces["special"]["register_tokens"]
        encoder.load_state_dict(params, strict=True)
        stitch_conv = pieces["stitch_conv"]
    elif getattr(args, "initialization_weight_path", None):
        init_sd = load_weights.load_torch_state_dict(
            args.initialization_weight_path)
        stitch_conv = {"weight": init_sd["weight"], "bias": init_sd["bias"]}
    else:
        raise ValueError("need --checkpoint_path or "
                         "--initialization_weight_path")
    if eval_dtype_bf16:
        cast_trunk_bf16(encoder)

    chopped = {f"encoder.{k}": v for k, v in encoder.state_dict().items()}
    chopped.update({f"stitch_conv.{k}": v for k, v in stitch_conv.items()})
    del encoder
    skeleton = wi.on_meta(lambda: ca.StitchedDecoder(scfg))
    if eval_dtype_bf16:
        cast_trunk_bf16(skeleton.encoder)
    own = skeleton.state_dict()
    left = sorted(k for k in chopped if k not in own)
    k = scfg.stitch_layer_index
    expected = ({"encoder.vit.patch_proj.weight",
                 "encoder.vit.patch_proj.bias"}
                | {n for n in chopped if n.startswith("encoder.vit.blocks.")
                   and int(n.split(".")[3]) < k})
    if set(left) != expected:
        raise KeyError(f"the chopped decoder drops {left}, not the patch "
                       f"embedding and ViT blocks [0, {k})")
    stitched = skeleton.to_empty(device=device)
    stitched.load_state_dict({n: chopped[n] for n in own}, strict=True)
    return ({"stitched": stitched.eval().requires_grad_(False),
             "vae": vae["decoder"]}, scfg)
