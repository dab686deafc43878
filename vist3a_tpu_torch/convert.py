"""Carry a JAX-package parameter tree over to the port's modules.

`from_jax_params(tree)` takes the pytree of `vist3a_tpu`'s `init` (or of
its checkpoint importer) as numpy arrays — or anything `np.asarray` reads,
bf16 included — and returns a flat state dict named like the port's
modules.  The layouts it changes:

  * stacked block leaves (`blocks`, `frame_blocks`, `global_blocks`,
    `trunk`, and UMT5's `layers`: a leading layer axis) split into
    per-block entries `<stack>.<i>.…`;
  * linear `w` (in, out) → `weight` (out, in); `b` → `bias`;
  * LayerNorm `scale` → `weight`;
  * heads convs `kernel_mat<k>` (k·k·ci, co), row-major over (kh, kw, ci)
    → `weight` OIHW;
  * `kernel_hwio` (kh, kw, c_out, c_in) of `conv_transpose2d` →
    ConvTranspose2d `weight` (c_in, c_out, kh, kw).  Both describe the
    forward conv that is being transposed, so this is a pure axis
    permutation: `lax.conv_transpose(transpose_kernel=True)` flips the
    spatial axes and swaps in/out itself, exactly as torch's transposed
    conv does with its weight;
  * the stitch conv `kernel` is already torch's (out, in, *k) → `weight`;
  * under the `vae` and `dit` subtrees the params are channels-last:
    `kernel` DHWIO → OIDHW and HWIO → OIHW (the DiT's patch embedding), and
    RMSNorm `gamma` → `weight`;
  * under the `umt5` subtree the dense weights are bare (in, out) arrays
    named `q`, `k`, `v`, `o`, `wi_0`, `wi_1`, `wo` → `<name>.weight`
    (out, in); the norms, bias tables and embedding keep name and layout.

`load_jax_params(module, tree)` loads that dict into a `StitchedDecoder`,
dropping what the chopped model does not hold (the patch embedding, the mask
token and the ViT blocks before the chop).  `load_jax_encoder_params` loads
a full encoder tree into an `Encoder` built with vit_start=0 (the
distillation teacher: patch embedding and every ViT block), dropping only
the mask token.  `load_jax_vae_params(module, tree)` loads the Wan VAE tree
into a `WanVAEDecoder` or a `WanVAEEncoder`, dropping the other half.
`load_jax_umt5_params` and `load_jax_dit_params` load the UMT5 and Wan DiT
trees into a `UMT5Encoder` and a `WanDiT`, strictly.

For the stitching trainer: `lora_from_jax(tree, k_chop)` carries a JAX
LoRA tree (`init_lora`'s, rooted at the encoder) over to the port's factors
keyed by the student's module names (`encoder.<site>`), and
`trainable_from_jax(tree, k_chop)` a `TrainState.trainable` (its LoRA
factors and its partitioned model leaves).  The factors keep the JAX
layout, a (in·k, r·k) and b (r·k, out·k): the port's merge takes
(a@b)ᵀ reshaped to the weight's shape, which is the JAX merge of every
site kind (linear, stacked linear, `conv`, `conv_hwio`, `kernel_mat<k>`)
followed by this converter's weight layout.  Both drop what the student
does not hold: rows [0, k) of the ViT blocks, the mask token, and the patch
embedding's factor and bias (no student path reads them; the JAX step
leaves the first two at their init and weight-decays the last).

For the VDM trainer: `dit_lora_from_jax(tree)` carries the DiT's stacked
LoRA tree (`init_lora` on `dit["blocks"]`) over to factors keyed
`blocks.<i>.<site>`; `vdm_state_from_jax(jax_state, state)` loads a JAX
`VDMTrainState` (its LoRA, both AdamW moments and their count, and the EMA
shadow) into the port's `VDMTrainState`; `load_jax_clip_vision_params`
loads a CLIP vision tree (`clip.init`) into a `CLIPVision` (the patch
kernel HWIO → OIHW; `proj` keeps its (width, projection_dim) layout).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vist3a_tpu_torch.nn.umt5 import DENSE as _UMT5_DENSE

_STACKS = ("blocks", "frame_blocks", "global_blocks", "trunk", "layers")
_CHANNELS_LAST = ("vae", "dit")


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))        # a writable copy


def _leaf(key: str, value: np.ndarray,
          subtree: str) -> tuple[str, np.ndarray]:
    channels_last = subtree in _CHANNELS_LAST
    if channels_last and key == "kernel":          # (*k, in, out) → (out, in, *k)
        n = value.ndim
        return "weight", value.transpose(n - 1, n - 2, *range(n - 2))
    if channels_last and key == "gamma":
        return "weight", value
    if subtree == "umt5" and key in _UMT5_DENSE:   # bare (in, out)
        return f"{key}.weight", value.T
    if key == "w":
        return "weight", value.T
    if key == "b":
        return "bias", value
    if key == "scale":
        return "weight", value
    if key == "kernel":
        return "weight", value
    if key.startswith("kernel_mat"):
        k = int(key[len("kernel_mat"):])
        ci = value.shape[0] // (k * k)
        return "weight", value.reshape(k, k, ci, value.shape[1]).transpose(
            3, 2, 0, 1)
    if key == "kernel_hwio":
        return "weight", value.transpose(3, 2, 0, 1)
    return key, value


def _walk(node, prefix: str, out: dict) -> None:
    """None leaves (the placeholders of a JAX `partition`) are skipped."""
    if isinstance(node, dict):
        for key, child in node.items():
            if child is None:
                continue
            if key in _STACKS:
                leaf = next(_leaves(child), None)
                for i in range(0 if leaf is None
                               else np.asarray(leaf).shape[0]):
                    _walk(_take(child, i), f"{prefix}{key}.{i}.", out)
            elif isinstance(child, (dict, list, tuple)):
                _walk(child, f"{prefix}{key}.", out)
            else:
                name, arr = _leaf(key, np.asarray(child),
                                  prefix.split(".", 1)[0])
                out[prefix + name] = _tensor(arr)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            if child is not None:
                _walk(child, f"{prefix}{i}.", out)
    else:
        raise TypeError(f"unexpected leaf at {prefix!r}")


def _leaves(node):
    if isinstance(node, dict):
        for child in node.values():
            yield from _leaves(child)
    elif isinstance(node, (list, tuple)):
        for child in node:
            yield from _leaves(child)
    elif node is not None:
        yield node


def _take(node, i: int):
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_take(v, i) for v in node]
    return None if node is None else np.asarray(node)[i]


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter pytree → flat state dict in the port's layouts."""
    out: dict[str, torch.Tensor] = {}
    _walk(tree, "", out)
    return out


def _load(module: nn.Module, sd: dict, dropped: tuple) -> nn.Module:
    """Strict on everything `module` holds; keys starting with one of
    `dropped` may be left out, any other stray key raises."""
    own = module.state_dict()
    stray = [k for k in sd if k not in own and not k.startswith(dropped)]
    if stray:
        raise KeyError(f"JAX params without a place in the module: {stray}")
    with torch.no_grad():
        module.load_state_dict({k: v for k, v in sd.items() if k in own},
                               strict=True)
    return module


def load_jax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a stitched-decoder JAX tree into a `StitchedDecoder`."""
    return _load(module, from_jax_params(tree),
                 ("encoder.vit.patch_proj.", "encoder.vit.mask_token",
                  "encoder.vit.blocks."))


def _subtree(name: str, tree: dict) -> dict[str, torch.Tensor]:
    """`from_jax_params` of `tree` read as the subtree `name`, keys without
    the `<name>.` prefix."""
    n = len(name) + 1
    return {k[n:]: v for k, v in from_jax_params({name: tree}).items()}


def load_jax_encoder_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a full encoder JAX tree (`encoder.init`) into an `Encoder` built
    with vit_start=0."""
    return _load(module, from_jax_params(tree), ("vit.mask_token",))


def load_jax_vae_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a Wan VAE JAX tree (`wan_vae.init`) into a `WanVAEDecoder` or a
    `WanVAEEncoder`; the top-level subtrees the module does not hold (the
    other half) are dropped."""
    dropped = tuple(f"{k}." for k in tree if not hasattr(module, k))
    return _load(module, _subtree("vae", tree), dropped)


def load_jax_umt5_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a UMT5 JAX tree (`umt5.init`) into a `UMT5Encoder`."""
    return _load(module, _subtree("umt5", tree), ())


def load_jax_dit_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a Wan DiT JAX tree (`wan_dit.init`) into a `WanDiT`."""
    return _load(module, _subtree("dit", tree), ())


def _student_holds(name: str, k_chop: int | None) -> bool:
    """Whether the student chopped at `k_chop` has the parameter `name`
    (None: the whole encoder, as the teacher holds it)."""
    if k_chop is None:
        return True
    if name.startswith(("encoder.vit.patch_proj.", "encoder.vit.mask_token")):
        return False
    parts = name.split(".")
    return not (parts[1:3] == ["vit", "blocks"] and int(parts[3]) < k_chop)


def _lora_factors(tree: dict, root: str, keep=lambda site: True
                  ) -> dict[str, dict]:
    """JAX LoRA tree rooted at `root` → {"<root>.<site>": {"a", "b"}},
    stacked factors split per block, the sites `keep` accepts."""
    out: dict[str, dict] = {}
    for name, value in from_jax_params({root: tree}).items():
        site, factor = name.rsplit(".", 1)
        if factor == "bias":          # `_leaf` renames a bare "b" to "bias"
            factor = "b"
        if keep(site):
            out.setdefault(site, {})[factor] = value
    return out


def lora_from_jax(tree: dict, k_chop: int | None) -> dict[str, dict]:
    """JAX LoRA tree (rooted at the encoder) → {site: {"a", "b"}} keyed by
    `encoder.<module name>`, stacked factors split per block; k_chop=None
    keeps every site (the teacher's)."""
    return _lora_factors(tree, "encoder",
                         lambda site: _student_holds(site + ".", k_chop))


def trainable_from_jax(tree: dict, k_chop: int) -> dict:
    """A JAX `TrainState.trainable` ({"lora", "model"}) → {"lora": {site:
    {"a", "b"}}, "model": {name: tensor}} in the port's names and layouts,
    without what the student does not hold."""
    model = {k: v for k, v in from_jax_params(tree["model"]).items()
             if _student_holds(k, k_chop)}
    return {"lora": lora_from_jax(tree["lora"], k_chop), "model": model}


def dit_lora_from_jax(tree: dict) -> dict[str, dict]:
    """JAX DiT LoRA tree (stacked, rooted at `blocks`) → {"blocks.<i>.<site>":
    {"a", "b"}}."""
    return _lora_factors(tree, "blocks")


def _adam_state(opt_state):
    """The optax `ScaleByAdamState` (count, mu, nu) inside a chain's
    state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def vdm_state_from_jax(jax_state, state) -> None:
    """Load a JAX `VDMTrainState` into the port's `VDMTrainState` in place:
    the step, the LoRA factors, AdamW's first and second moments and step
    count, and the EMA shadow."""
    lora = dit_lora_from_jax(jax_state.lora)
    adam = _adam_state(jax_state.opt_state)
    mu, nu = dit_lora_from_jax(adam.mu), dit_lora_from_jax(adam.nu)
    count = float(np.asarray(adam.count))
    ema = dit_lora_from_jax(jax_state.ema)
    state.step = int(np.asarray(jax_state.step))
    with torch.no_grad():
        for site, f in state.lora.items():
            for k in ("a", "b"):
                p = f[k]
                p.copy_(lora[site][k])
                st = state.optimizer.state[p]
                st["step"] = torch.tensor(count)
                st["exp_avg"] = mu[site][k].to(p.device, p.dtype).clone()
                st["exp_avg_sq"] = nu[site][k].to(p.device, p.dtype).clone()
                state.ema[f"{site}.{k}"].copy_(ema[site][k])


def load_jax_clip_vision_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a CLIP vision JAX tree (`clip.init`) into a `CLIPVision`."""
    sd = from_jax_params({k: v for k, v in tree.items() if k != "patch"})
    sd["patch"] = _tensor(np.asarray(tree["patch"]).transpose(3, 2, 0, 1))
    return _load(module, sd, ())
