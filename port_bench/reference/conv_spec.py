"""The plain reference's conv-spec string DSL for the stitching layer
(frozen from the port's `stitch/conv_spec.py`; see `reference/scene.py`;
it imports nothing of the port).

    conv{1,2,3}d_k<K>_o<OUT>[_s<S>][_p<P>][_d<D>]

where each of K/S/P/D is an int or an ``x``-joined tuple, e.g. the canonical
VIST3A stitch ``conv3d_k5x3x3_o1024_s1x2x2_p2x1x1`` (16-channel latent →
1024-channel tokens, spatial stride 2).  The conv pads with the edge values
(torch's ``padding_mode="replicate"``) and then runs a VALID convolution;
the kernel keeps torch's (out, in, *spatial) layout.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IntOrTuple = Union[int, Tuple[int, ...]]

_SPEC_RE = re.compile(
    r"^conv(?P<dim>[123])d"
    r"_k(?P<k>[0-9x]+)"
    r"_o(?P<o>[0-9]+)"
    r"(?:_s(?P<s>[0-9x]+))?"
    r"(?:_p(?P<p>[0-9x]+))?"
    r"(?:_d(?P<d>[0-9x]+))?$",
    re.IGNORECASE,
)

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _parse_num(txt: str | None, default: int) -> IntOrTuple:
    if not txt:
        return default
    if "x" in txt:
        return tuple(int(t) for t in txt.split("x"))
    return int(txt)


def _as_tuple(v: IntOrTuple, dim: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * dim
    if len(v) != dim:
        raise ValueError(f"expected {dim}-tuple, got {v}")
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Declarative N-d convolution spec (N in {1,2,3})."""

    dim: int
    out_channels: int
    kernel_size: IntOrTuple
    stride: IntOrTuple = 1
    padding: IntOrTuple = 0
    dilation: IntOrTuple = 1

    def kernel_shape(self, in_channels: int) -> Tuple[int, ...]:
        """(out, in, *spatial), torch's layout."""
        return (self.out_channels, in_channels,
                *_as_tuple(self.kernel_size, self.dim))

    def apply(self, weight: torch.Tensor, bias: torch.Tensor | None,
              x: torch.Tensor) -> torch.Tensor:
        """x: (B, C_in, *spatial) → edge padding, then a VALID conv in the
        input dtype (fp32 accumulation for bf16 inputs)."""
        pad = _as_tuple(self.padding, self.dim)
        if any(pad):
            # F.pad lists the last spatial axis first
            x = F.pad(x, [q for p in reversed(pad) for q in (p, p)],
                      mode="replicate")
        return _CONV[self.dim](
            x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
            stride=_as_tuple(self.stride, self.dim),
            dilation=_as_tuple(self.dilation, self.dim))


class SpecConv(nn.Module):
    """The stitch conv as a module: `weight` (out, in, *k) and `bias`."""

    def __init__(self, spec: ConvSpec, in_channels: int, bias: bool = True):
        super().__init__()
        self.spec = spec
        self.weight = nn.Parameter(torch.empty(spec.kernel_shape(in_channels)))
        self.bias = nn.Parameter(torch.empty(spec.out_channels)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spec.apply(self.weight, self.bias, x)


def parse_conv_spec(spec: str) -> ConvSpec:
    """Parse ``conv3d_k5x3x3_o1024_s1x2x2_p2x1x1`` → ConvSpec; ValueError on
    a string outside the grammar."""
    m = _SPEC_RE.fullmatch(spec)
    if not m:
        raise ValueError(
            f"Bad conv spec {spec!r}; expected e.g. 'conv2d_k3_o64', "
            "'conv3d_k5x3x3_o1024_s1x2x2_p2x1x1'")
    g = m.groupdict()
    return ConvSpec(dim=int(g["dim"]), out_channels=int(g["o"]),
                    kernel_size=_parse_num(g["k"], 1),
                    stride=_parse_num(g["s"], 1),
                    padding=_parse_num(g["p"], 0),
                    dilation=_parse_num(g["d"], 1))



