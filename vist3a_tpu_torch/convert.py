"""Carry a JAX-package parameter tree over to the port's modules.

`from_jax_params(tree)` takes the pytree of `vist3a_tpu`'s `init` (or of
its checkpoint importer) as numpy arrays — or anything `np.asarray` reads,
bf16 included — and returns a flat state dict named like the port's
modules.  The layouts it changes:

  * stacked block leaves (`blocks`, `frame_blocks`, `global_blocks`,
    `trunk`: a leading layer axis) split into per-block entries
    `<stack>.<i>.…`;
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
  * the stitch conv `kernel` is already torch's (out, in, *k) → `weight`.

`load_jax_params(module, tree)` loads that dict into a `StitchedDecoder`,
dropping what the chopped model does not hold (the patch embedding, the mask
token and the ViT blocks before the chop).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_STACKS = ("blocks", "frame_blocks", "global_blocks", "trunk")


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))        # a writable copy


def _leaf(key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
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
    if isinstance(node, dict):
        for key, child in node.items():
            if key in _STACKS:
                depth = np.asarray(next(_leaves(child))).shape[0]
                for i in range(depth):
                    _walk(_take(child, i), f"{prefix}{key}.{i}.", out)
            elif isinstance(child, (dict, list, tuple)):
                _walk(child, f"{prefix}{key}.", out)
            else:
                name, arr = _leaf(key, np.asarray(child))
                out[prefix + name] = _tensor(arr)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
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
    else:
        yield node


def _take(node, i: int):
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_take(v, i) for v in node]
    return np.asarray(node)[i]


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter pytree → flat state dict in the port's layouts."""
    out: dict[str, torch.Tensor] = {}
    _walk(tree, "", out)
    return out


def load_jax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX tree into `module` (strict on everything it holds)."""
    sd = from_jax_params(tree)
    own = module.state_dict()
    stray = [k for k in sd if k not in own and not k.startswith(
        ("encoder.vit.patch_proj.", "encoder.vit.mask_token",
         "encoder.vit.blocks."))]
    if stray:
        raise KeyError(f"JAX params without a place in the module: {stray}")
    with torch.no_grad():
        module.load_state_dict({k: v for k, v in sd.items() if k in own},
                               strict=True)
    return module
