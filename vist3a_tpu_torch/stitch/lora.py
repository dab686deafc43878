"""Functional LoRA over the port's modules: factors keyed by site name,
merged into the weights that `torch.func.functional_call` feeds a module.

Port of `vist3a_tpu/stitch/lora.py`.  The spec DSL (`r64,a32,d0.0,f0` and
`b<bias>`, `t<a|b>`, `enc`, `fix_head`) is `parse_lora_mode`.  A site is a
module whose own `weight` is a linear's (2-D) or a square conv kernel
(4-D, kh = kw) — the JAX package's `linear`, stacked-linear, `conv`,
`conv_hwio` and `kernel_mat<k>` sites, which the port holds as per-block
`Linear`s and OIHW `Conv2d`s — except the DPT `resize0` / `resize1`
transposed convs, which the reference does not wrap.

The factors keep the JAX layout, a (in·k, r·k) and b (r·k, out·k) (k = 1
for a linear; a = torch `lora_A`ᵀ, b = `lora_B`ᵀ), and `merge_lora` adds
scaling·(a@b)ᵀ reshaped to the weight's shape: for a linear weight (out,
in) that is the JAX w + a@b transposed, for an OIHW kernel the JAX
(o, i, kh, kw) view of (a@b)ᵀ — one rule for every site kind.  The merge
is functional, base + delta as new tensors, as the JAX package merges and
then applies; a forward hook adding the delta to the output would round
differently.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional, Tuple

import torch
from torch import nn

# conv-transpose sites (DPT "resize" upsamplers) are not wrapped by the
# reference (`add_lora` targets nn.Linear / nn.Conv2d only)
_EXCLUDED_KEYS = ("resize0", "resize1")
_STACKS = ("blocks", "frame_blocks", "global_blocks", "trunk")


@dataclasses.dataclass
class LoraConfig:
    r: int = 8
    alpha: int = 32
    dropout: float = 0.0
    bias: str = "lora_only"
    target_modules: Optional[Tuple[str, ...]] = None
    fan_in_fan_out: bool = False
    finetune_encoder: bool = False
    freeze_head: bool = False

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def parse_lora_mode(spec: str) -> LoraConfig:
    """The reference's grammar (`utils/lora_util/utils.py:68-117`)."""
    cfg = LoraConfig()
    pattern = re.compile(
        r"(?P<key>[radbft])(?:(?P<num>[\d.]+)|(?P<str>[^,]+))")
    for chunk in spec.split(","):
        chunk = chunk.strip().lower()
        if not chunk:
            continue
        if chunk == "enc":
            cfg.finetune_encoder = True
            continue
        if chunk in {"fix_head", "fixhead"}:
            cfg.freeze_head = True
            continue
        m = pattern.fullmatch(chunk)
        if not m:
            raise ValueError(f"Bad LoRA chunk: {chunk!r}")
        k = m["key"]
        if k == "r":
            cfg.r = int(m["num"])
        elif k == "a":
            cfg.alpha = int(m["num"])
        elif k == "d":
            cfg.dropout = float(m["num"])
        elif k == "b":
            cfg.bias = m["str"]
            if cfg.bias not in {"none", "all", "lora_only"}:
                raise ValueError("b chunk must be none|all|lora_only")
        elif k == "t":
            cfg.target_modules = tuple(m["str"].split("|"))
        elif k == "f":
            cfg.fan_in_fan_out = bool(int(m["num"]))
    return cfg


def jax_path(name: str) -> str:
    """A module name as the JAX tree's path, "/"-joined: the block index
    after a stack (the JAX stack's leading axis) dropped, list indices
    kept."""
    parts = name.split(".")
    return "/".join(p for i, p in enumerate(parts)
                    if not (p.isdigit() and i and parts[i - 1] in _STACKS))


def _is_site(module: nn.Module) -> bool:
    w = module._parameters.get("weight")
    return w is not None and (w.dim() == 2 or (w.dim() == 4
                                               and w.shape[-1] == w.shape[-2]))


def lora_sites(model: nn.Module, cfg: LoraConfig) -> list[str]:
    """The names of `model`'s eligible sites, in module order."""
    out = []
    for name, module in model.named_modules():
        if not _is_site(module) or name.rsplit(".", 1)[-1] in _EXCLUDED_KEYS:
            continue
        if cfg.target_modules and not any(t in jax_path(name)
                                          for t in cfg.target_modules):
            continue
        out.append(name)
    return out


def _factor_shapes(weight_shape, r: int):
    """((a shape), (b shape), fan-in of a's init)."""
    if len(weight_shape) == 2:
        d_out, d_in = weight_shape
        return (d_in, r), (r, d_out), d_in
    o, i, k, _ = weight_shape
    return (i * k, r * k), (r * k, o * k), i * k


def init_lora(model: nn.Module, cfg: LoraConfig,
              generator: torch.Generator) -> dict[str, dict[str, nn.Parameter]]:
    """{site: {"a", "b"}} for every site of `model`, fp32, on the
    generator's device: a uniform ±1/√fan_in (the reference's kaiming), b
    zero, so a merge at init changes nothing."""
    modules = dict(model.named_modules())
    device = generator.device
    out = {}
    for site in lora_sites(model, cfg):
        a_shape, b_shape, fan_in = _factor_shapes(
            modules[site].weight.shape, cfg.r)
        bound = 1.0 / math.sqrt(fan_in)
        a = torch.empty(a_shape, device=device).uniform_(
            -bound, bound, generator=generator)
        out[site] = {"a": nn.Parameter(a),
                     "b": nn.Parameter(torch.zeros(b_shape, device=device))}
    return out


def merge_lora(params: dict[str, torch.Tensor], lora: dict[str, dict],
               cfg: LoraConfig) -> dict[str, torch.Tensor]:
    """`params` (name → tensor) with scaling·(a@b)ᵀ added to the weight of
    every site in `lora`, in the weight's dtype, as new tensors."""
    out = dict(params)
    for site, f in lora.items():
        w = params[f"{site}.weight"]
        delta = (torch.matmul(f["a"], f["b"]) * cfg.scaling).to(w.dtype)
        out[f"{site}.weight"] = w + delta.T.reshape(w.shape)
    return out


def lora_bias_predicate(model: nn.Module,
                        cfg: LoraConfig) -> Callable[[str], bool]:
    """Name predicate for the biases that bias="lora_only" trains
    (`utils/lora_util/utils.py:27-31`): the bias of every site."""
    biases = {f"{site}.bias" for site in lora_sites(model, cfg)}
    return biases.__contains__


def factors_by_block(lora: dict[str, dict],
                     n_blocks: int) -> list[dict[str, dict]]:
    """The factors of the sites `blocks.<i>.<site>` for each block i, keyed
    by the site's name inside the block (the DiT merges them per block,
    inside its recompute)."""
    out: list[dict[str, dict]] = [{} for _ in range(n_blocks)]
    for site, f in lora.items():
        _, i, name = site.split(".", 2)
        out[int(i)][name] = f
    return out
