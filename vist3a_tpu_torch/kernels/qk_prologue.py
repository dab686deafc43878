"""The Wan DiT's q/k prologue: one kernel between an attention layer's
input products and the attention, its wrapper and its plain version.

`qk_prologue(x, biases, scales, eps, head_dim, rope)` takes the bias-free
product x (B, N, P·d) of P parts (P = len(biases)) and returns P tensors
(B, N, d/head_dim, head_dim), contiguous: part i plus its bias, and for the
first len(scales) parts the q/k RMSNorm across the full width d
(`nn/layers.py::rms_norm`) and, with `rope` = the (cos, sin) fp32 tables
(N, head_dim/2), the 3D RoPE of `nn/wan_dit.py::apply_rope`.  The DiT's
self-attention calls it with the fused QKV product (q and k normed and
rotated, v with its bias only), its cross-attention once for q over the
latent tokens and once for k over the text tokens, without tables.

It replaces no TPU kernel: XLA fused this chain on the TPU.  On the card it
replaces ~35 PyTorch launches a layer; its bound is bytes, each element read
once and written once: 6 planes of (B, N, d) a self-attention call, 2 a
cross-attention q.  See `csrc/qk_prologue.cu` for the design and the
rounding points, which are the plain version's.

A call on tensors off the card runs the plain version (`qk_prologue_ref`,
the composition the DiT ran before the kernel: bias add, `rms_norm`,
`apply_rope`, the same ops in that arithmetic): CPU tensors, and the meta
tensors on which the benchmark's FLOP counts trace the DiT.  The DiT calls
the plain version itself with grad enabled, as the kernel has no backward.
On CUDA tensors (bf16, the DiT's dtype on the card) it launches the kernel
or raises.  Each launch adds one to `launches`.
"""

from __future__ import annotations

import ctypes

import torch

from vist3a_tpu_torch.kernels import build
from vist3a_tpu_torch.nn.layers import rms_norm

SOURCE = "qk_prologue.cu"
VEC = 8                 # columns of a part each thread owns
MAX_WIDTH = 8 * 1024    # d: one block of at most 1024 threads owns a row

launches = 0


def reset_launch_counts() -> None:
    global launches
    launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = (_P,) * 11 + (_I,) * 6 + (_F, _P)


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.qk_prologue.argtypes is None:
        lib.qk_prologue.restype = ctypes.c_int
        lib.qk_prologue.argtypes = list(ARGTYPES)
    return lib


def qk_prologue_ref(x: torch.Tensor, biases: tuple, scales: tuple,
                    eps: float, head_dim: int, rope: tuple | None = None
                    ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: the DiT's own ops (one bias add
    over the whole product, the split, `rms_norm`, `apply_rope`)."""
    # imported here: nn/wan_dit.py imports this module
    from vist3a_tpu_torch.nn.wan_dit import apply_rope

    b, n, _ = x.shape
    d = biases[0].shape[0]
    y = x + torch.cat(biases).to(x.dtype)
    # one part unsplit: a split's backward would lay the gradient out anew,
    # and the bias's gradient sums it in another order
    parts = y.split(d, dim=-1) if len(biases) > 1 else (y,)
    outs = []
    for i, y in enumerate(parts):
        if i < len(scales):
            y = rms_norm(scales[i], y, eps)
        y = y.reshape(b, n, -1, head_dim)
        if i < len(scales) and rope is not None:
            y = apply_rope(y, *rope)
        outs.append(y.contiguous())       # v too, as the kernel writes it
    return tuple(outs)


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _check(x, biases, scales, head_dim, rope) -> None:
    if any(t.dtype != torch.bfloat16 for t in (x, *biases, *scales)):
        raise TypeError(f"the q/k prologue kernel takes bf16 activations, "
                        f"biases and scales (the DiT's dtype on the card), "
                        f"not {x.dtype}, {[t.dtype for t in biases]}, "
                        f"{[t.dtype for t in scales]}")
    if x.dim() != 3 or not _aligned(x):
        raise ValueError(f"x must be a contiguous, 16-byte aligned (B, N, "
                         f"P·d) tensor, got {tuple(x.shape)} strides "
                         f"{x.stride()}")
    d = biases[0].shape[0]
    if not 1 <= len(scales) <= min(2, len(biases)) or len(biases) > 3:
        raise ValueError(f"{len(biases)} biases and {len(scales)} scales: "
                         f"the kernel takes 1-3 parts, 1-2 of them normed")
    if x.shape[-1] != len(biases) * d:
        raise ValueError(f"x's width {x.shape[-1]} is not {len(biases)} "
                         f"parts of {d}")
    if d % VEC or d > MAX_WIDTH or head_dim % VEC or d % head_dim:
        raise ValueError(f"width {d}, head_dim {head_dim}: the kernel takes "
                         f"multiples of {VEC} up to {MAX_WIDTH}, whole heads")
    for t in (*biases, *scales):
        if t.shape != (d,) or t.device != x.device or not _aligned(t):
            raise ValueError(f"biases and scales must be contiguous, aligned "
                             f"({d},) tensors on {x.device}")
    if rope is not None:
        want = (x.shape[1], head_dim // 2)
        for t in rope:
            if (t.dtype != torch.float32 or tuple(t.shape) != want
                    or t.device != x.device or not _aligned(t)):
                raise ValueError(f"the RoPE tables must be contiguous fp32 "
                                 f"{want} on {x.device}")


def qk_prologue(x: torch.Tensor, biases: tuple, scales: tuple, eps: float,
                head_dim: int, rope: tuple | None = None
                ) -> tuple[torch.Tensor, ...]:
    """The kernel on CUDA tensors, the plain version on any other."""
    global launches
    if x.device.type != "cuda":
        return qk_prologue_ref(x, biases, scales, eps, head_dim, rope)
    biases = tuple(t.to(x.dtype) for t in biases)
    _check(x, biases, scales, head_dim, rope)
    b, n, _ = x.shape
    d = biases[0].shape[0]
    outs = tuple(torch.empty((b, n, d // head_dim, head_dim), dtype=x.dtype,
                             device=x.device) for _ in biases)
    ptrs = [t.data_ptr() for t in biases] + [None] * (3 - len(biases))
    sptrs = [t.data_ptr() for t in scales] + [None] * (2 - len(scales))
    optrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
    cos, sin = (None, None) if rope is None else \
        (rope[0].data_ptr(), rope[1].data_ptr())
    with torch.cuda.device(x.device):
        err = _lib().qk_prologue(
            x.data_ptr(), *ptrs, *sptrs, cos, sin, *optrs, b * n, n, d,
            head_dim, len(biases), len(scales), float(eps),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"qk_prologue launch failed: error {err}")
    launches += 1
    return outs
