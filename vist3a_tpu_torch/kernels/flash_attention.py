"""Flash-attention forward: the Hopper kernel, its wrapper and its plain version.

Counterpart of `vist3a_tpu/kernels/flash_attention.py`'s forward entries
`flash_attention` (transposed layout, `_fwd_kernel_t` and its online-max
fallback), `flash_attention_masked`, and `flash_attention` in the natural
layout (`_fwd_kernel`, which the JAX package runs for an unmasked call with
head_dim 128: the Wan DiT's self-attention).  One CUDA source,
`csrc/flash_attention_fwd.cu`, and one entry serve all three: the
key-validity pointer is null for an unmasked call, and head_dim 128 selects
its DP = 128 instantiation.  See that file for the design and its bound.

Semantics, shared by kernel and plain version:
  * q (B, N_q, H, D), k and v (B, N_k, H, D), non-causal, scale D^-1/2 by
    default; returns O (B, N_q, H, D) in the input dtype and the natural-log
    LSE (B, H, N_q) in fp32;
  * key_valid: optional (N_k,) bool — False keys contribute exactly nothing;
  * a row with no live key gives O = 0 and LSE = −1e30·ln 2 (the running
    max starts at the finite −1e30 and the empty sum divides by 1, the
    `safe_l` rule of the TPU kernel).

The natural-layout TPU kernel multiplies q by scale·log2(e) in the input
dtype before the product; here (kernel and plain version) the fp32 scores
are scaled, one rounding fewer.

A wrapper call on CPU tensors runs `flash_attention_ref`; on CUDA tensors it
launches the kernel or raises.  Each launch adds one to a counter by the
TPU entry it stands for: `launches_masked` (key_valid given),
`launches_natural` (unmasked, head_dim 128) or `launches_unmasked`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vist3a_tpu_torch.kernels import build

SOURCE = "flash_attention_fwd.cu"
MAX_HEAD_DIM = 128
NATURAL_HEAD_DIM = 128
_NEG_BIG = -1e30
_LOG2E = 1.4426950408889634

launches_unmasked = 0
launches_masked = 0
launches_natural = 0


def reset_launch_counts() -> None:
    global launches_unmasked, launches_masked, launches_natural
    launches_unmasked = 0
    launches_masked = 0
    launches_natural = 0


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (O, LSE), computed in fp32.

    Follows the kernel's base-2 softmax with the running max floored at
    −1e30, so rows with no live key agree with it exactly."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s2 = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) \
        * (scale * _LOG2E)
    live = torch.ones(k.shape[1], dtype=torch.bool, device=q.device) \
        if key_valid is None else key_valid.to(q.device, torch.bool)
    s2 = s2.masked_fill(~live, -math.inf)
    m = s2.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float()) \
        / safe_l.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log2(safe_l)).squeeze(-1) / _LOG2E
    return o.to(q.dtype), lse


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.flash_attention_fwd_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(q, k, v, key_valid) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the flash-attention kernel takes bf16, "
                            f"{name} is {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, N, H, D), got {tuple(x.shape)}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(f"{name} strides {x.stride()}: the kernel needs a "
                             "unit last stride and the others multiples of 8")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if key_valid is not None:
        if key_valid.device != q.device or key_valid.dtype != torch.bool:
            raise TypeError("key_valid must be a bool tensor on q's device")
        if key_valid.shape != (k.shape[1],) or not key_valid.is_contiguous():
            raise ValueError(f"key_valid must be contiguous ({k.shape[1]},), "
                             f"got {tuple(key_valid.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) — the kernel on CUDA tensors, the plain version on CPU."""
    global launches_unmasked, launches_masked, launches_natural
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, key_valid, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    _check(q, k, v, key_valid)
    b, n_q, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_valid is None else key_valid.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, n_q, k.shape[1], h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd_bf16 launch failed: "
                           f"cudaError {err}")
    if key_valid is not None:
        launches_masked += 1
    elif d == NATURAL_HEAD_DIM:
        launches_natural += 1
    else:
        launches_unmasked += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention output O only (the inference trunk needs no LSE)."""
    return flash_attention_fwd(q, k, v, key_valid, scale)[0]
