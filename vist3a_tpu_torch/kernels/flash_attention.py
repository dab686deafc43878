"""Flash attention: the Hopper kernels, their wrappers and plain versions.

Counterpart of `vist3a_tpu/kernels/flash_attention.py`'s forward entries
`flash_attention` (transposed layout, `_fwd_kernel_t` and its online-max
fallback), `flash_attention_masked`, and `flash_attention` in the natural
layout (`_fwd_kernel`, which the JAX package runs for an unmasked call with
head_dim 128: the Wan DiT's self-attention), and of both layouts' VJPs
(`_dq_kernel_t` / `_dkv_kernel_t` and `_dq_kernel` / `_dkv_kernel`).

`route` names the kernel a call takes.  Every bf16 call at head_dim 64 or
128, masked or not, goes to the Hopper wgmma + TMA kernels of
`csrc/flash_attention_fwd_sm90.cu` and `csrc/flash_attention_bwd_sm90.cu`
(the stitched decoder's attention at 64, the Wan DiT's at 128); a masked
call hands them the key validity as a padded 0/−∞ bias row and a flag a
key tile (`key_bias`).
Every fp32 call (head_dim ≤ 64, the distillation step's) goes to
`csrc/flash_attention_fwd_f32_sm90.cu` and
`csrc/flash_attention_bwd_f32_sm90.cu`: wgmma + TMA (and mma.sync for the
backward's accumulating products) on the TF32 tensor cores with the 3×TF32
split (`tf32_split`), which keeps about fp32's accuracy.  The mma.sync
kernels of `csrc/flash_attention_fwd.cu` (one entry; the key-validity
pointer is null for an unmasked call) and `csrc/flash_attention_bwd.cu`
keep the other bf16 head dims (multiples of 8 up to 128).  See those files
for the designs and their bounds.

`FlashAttention` is the autograd function the attention dispatch calls on
the card: its forward saves q, k, v, O and the LSE, its backward calls
`flash_attention_bwd`.  A masked call has no backward (the JAX package has
no masked VJP) and raises `NotImplementedError`; nothing falls back to
plain math, so a gradient is never silently dropped.

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

A wrapper call on CPU tensors runs the plain version (`flash_attention_ref`,
`flash_attention_bwd_ref`); on CUDA tensors it launches the kernel or raises.
Each forward launch adds one to a counter by the TPU entry it stands for:
`launches_masked` (key_valid given), `launches_natural` (unmasked, head_dim
128) or `launches_unmasked` (bf16 or fp32); each backward launch (its two
kernels) adds one to `launches_backward` (fp32), `launches_backward_bf16`
(bf16, head_dim < 128: the transposed entry's VJP) or
`launches_backward_natural` (bf16, head_dim 128: the natural entry's).
"""

from __future__ import annotations

import ctypes
import math

import torch

from vist3a_tpu_torch.kernels import build

SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
SM90_SOURCE = "flash_attention_fwd_sm90.cu"
SM90_BWD_SOURCE = "flash_attention_bwd_sm90.cu"
F32_SOURCE = "flash_attention_fwd_f32_sm90.cu"
F32_BWD_SOURCE = "flash_attention_bwd_f32_sm90.cu"
MAX_HEAD_DIM = 128
MAX_HEAD_DIM_F32 = 64          # the fp32 forward's and backward's
NATURAL_HEAD_DIM = 128
WGMMA_HEAD_DIMS = (64, 128)    # the bf16 head dims of the wgmma kernels
KEY_TILE = 128                 # the wgmma forward's keys per tile
F32_KEY_TILE = 64              # the fp32 forward's keys per stage
F32_ROW_TILE = 128             # the fp32 backward's rows per block
_NEG_BIG = -1e30
_LOG2E = 1.4426950408889634

launches_unmasked = 0
launches_masked = 0
launches_natural = 0
launches_backward = 0
launches_backward_bf16 = 0
launches_backward_natural = 0


def reset_launch_counts() -> None:
    global launches_unmasked, launches_masked, launches_natural
    global launches_backward, launches_backward_bf16
    global launches_backward_natural
    launches_unmasked = 0
    launches_masked = 0
    launches_natural = 0
    launches_backward = 0
    launches_backward_bf16 = 0
    launches_backward_natural = 0


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (the gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (O, LSE), computed in fp32.

    Follows the kernel's base-2 softmax with the running max floored at
    −1e30, so rows with no live key agree with it exactly."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    ct = _compute_dtype(q)
    s2 = torch.einsum("bnhd,bmhd->bhnm", q.to(ct), k.to(ct)) \
        * (scale * _LOG2E)
    live = torch.ones(k.shape[1], dtype=torch.bool, device=q.device) \
        if key_valid is None else key_valid.to(q.device, torch.bool)
    s2 = s2.masked_fill(~live, -math.inf)
    m = s2.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.to(ct)) \
        / safe_l.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log2(safe_l)).squeeze(-1) / _LOG2E
    return o.to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the backward kernels: (dQ, dK, dV) in the
    input dtype, computed in fp32 from the forward's O and LSE:
    δ = rowsum(dO∘O), P = exp(scale·qkᵀ − LSE), dV = PᵀdO,
    dS = P∘(dO·Vᵀ − δ), dQ = scale·dS·K, dK = scale·dSᵀ·Q.  For bf16
    inputs it keeps P and dS in fp32, where the bf16 kernel (like the TPU
    kernels) rounds them to bf16 before the products."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    ct = _compute_dtype(q)
    qf, kf, vf, dof = (x.to(ct) for x in (q, k, v, do))
    delta = (dof * o.to(ct)).sum(-1).transpose(1, 2)           # (B, H, N_q)
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    p = torch.exp(s - lse.to(ct)[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def route(dtype: torch.dtype, head_dim: int, masked: bool) -> str:
    """The kernel a call on the card takes, forward and backward: "wgmma"
    (the Hopper wgmma + TMA kernels, `SM90_SOURCE` and `SM90_BWD_SOURCE`)
    for bf16 at head_dim 64 or 128, masked or not; "fp32" (the 3×TF32
    wgmma + TMA kernels of `F32_SOURCE` and `F32_BWD_SOURCE`) for fp32;
    "mma_sync" (the mma.sync kernels of `SOURCE` and `BWD_SOURCE`) for
    every other bf16 head dim.  `masked` chooses no route: every forward
    takes a mask, and no backward does."""
    if dtype == torch.float32:
        return "fp32"
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma_sync"


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3×TF32 split of fp32 x → (big, small): big is x rounded to TF32
    (its low 13 mantissa bits zero; to nearest, ties away from zero, as
    `cvt.rna.tf32.f32`), small is x − big rounded the same way, so that
    a·b ≈ a_big·b_big + a_big·b_small + a_small·b_big to about fp32's
    accuracy (|x − big − small| ≤ 2⁻²²·|x| for normal x whose remainder is
    normal too).  The fp32 kernels split every operand so
    (`csrc/sm90.cuh::tf32_round`); this is their plain version."""
    def rna(y):
        bits = y.contiguous().view(torch.int32)
        r = ((bits + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(torch.isnan(y), y, r)
    big = rna(x)
    return big, rna(x - big)


def key_bias(key_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The key validity as the wgmma forward reads it → (bias, tile_masked):
    an fp32 row of 0 for a live key and −∞ for a dead one, padded with −∞
    to whole `KEY_TILE` tiles, so that the scores plus the bias give every
    dead key, and every key beyond N_k, a P of exactly 0; and a uint8 a
    tile, 1 where the tile holds a −∞ (the kernel adds the bias there
    only)."""
    n_k = key_valid.shape[0]
    n_pad = -(-n_k // KEY_TILE) * KEY_TILE
    bias = torch.full((n_pad,), -math.inf, dtype=torch.float32,
                      device=key_valid.device)
    bias[:n_k].masked_fill_(key_valid, 0.0)
    tile_masked = (bias.view(-1, KEY_TILE) != 0).any(1).to(torch.uint8)
    return bias, tile_masked


_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# The ctypes signature of each C entry: (source, entry) → argument types.
ARGTYPES = {
    (SOURCE, "flash_attention_fwd"):
        (_P,) * 6 + (_I,) * 5 + (_L,) * 12 + (_F, _P),
    (BWD_SOURCE, "flash_attention_bwd_bf16"):
        (_P,) * 9 + (_I,) * 5 + (_L,) * 21 + (_F, _P),
    (SM90_SOURCE, "flash_attention_fwd_sm90"):
        (_P,) * 7 + (_I,) * 5 + (_L,) * 12 + (_F, _P),
    (SM90_BWD_SOURCE, "flash_attention_bwd_sm90"):
        (_P,) * 9 + (_I,) * 6 + (_L,) * 21 + (_F, _P),
    (F32_SOURCE, "flash_attention_fwd_f32_sm90"):
        (_P,) * 9 + (_I,) * 6 + (_L,) * 12 + (_F, _P),
    (F32_BWD_SOURCE, "flash_attention_bwd_f32_sm90"):
        (_P,) * 10 + (_I,) * 7 + (_L,) * 21 + (_F, _P),
    # the wgmma kernels' dynamic shared memory a block, for the build log
    (SM90_SOURCE, "flash_attention_fwd_sm90_smem"): (_I,),
    (SM90_BWD_SOURCE, "flash_attention_bwd_sm90_smem"): (_I, _I),
    (F32_SOURCE, "flash_attention_fwd_f32_sm90_smem"): (_I,),
    (F32_BWD_SOURCE, "flash_attention_bwd_f32_sm90_smem"): (_I, _I),
}


def _bind(source: str) -> ctypes.CDLL:
    """Build and load `source`, with the argument types of its entries."""
    lib = build.load(source)
    for (src, entry), argtypes in ARGTYPES.items():
        fn = getattr(lib, entry) if src == source else None
        if fn is not None and fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(SOURCE)


def _bwd_lib() -> ctypes.CDLL:
    return _bind(BWD_SOURCE)


def _sm90_lib() -> ctypes.CDLL:
    return _bind(SM90_SOURCE)


def _sm90_bwd_lib() -> ctypes.CDLL:
    return _bind(SM90_BWD_SOURCE)


def _f32_lib() -> ctypes.CDLL:
    return _bind(F32_SOURCE)


def _f32_bwd_lib() -> ctypes.CDLL:
    return _bind(F32_BWD_SOURCE)


def _ceil_to(n: int, tile: int) -> int:
    return -(-n // tile) * tile


def _loadable(x: torch.Tensor) -> bool:
    """The strides and alignment the kernels' 16-byte loads need: the last
    stride 1, the others multiples of 16 bytes, the start 16-byte aligned."""
    per16 = 16 // x.element_size()
    return (x.stride(-1) == 1 and not any(s % per16 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_operand(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device != like.device:
        raise ValueError(f"{name} on {x.device}, q on {like.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dtype != like.dtype:
        raise TypeError(f"the flash-attention kernels take bf16 or fp32 "
                        f"q, k, v of one dtype; {name} is {x.dtype}, q "
                        f"{like.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, N, H, D), got {tuple(x.shape)}")
    if not _loadable(x):
        raise ValueError(f"{name} strides {x.stride()}: the kernels need a "
                         f"unit last stride, the others multiples of 16 "
                         f"bytes, and a 16-byte aligned start")


def _check(q, k, v, key_valid) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q)
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.dtype == torch.float32:
        if d % 4 or not 0 < d <= MAX_HEAD_DIM_F32:
            raise ValueError(f"head_dim {d}: the fp32 kernels take multiples "
                             f"of 4 up to {MAX_HEAD_DIM_F32}")
    elif d % 8 or not 0 < d <= MAX_HEAD_DIM:
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
    path = route(q.dtype, d, key_valid is not None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *o.stride()[:3])
        bias, tiles = (None, None) if key_valid is None or path == "mma_sync" \
            else key_bias(key_valid)
        bias_ptr = None if bias is None else bias.data_ptr()
        tiles_ptr = None if tiles is None else tiles.data_ptr()
        if path == "wgmma":
            err = _sm90_lib().flash_attention_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                tiles_ptr, o.data_ptr(), lse.data_ptr(), b, n_q, k.shape[1],
                h, d, *strides, float(scale), stream)
        elif path == "fp32":
            # scratch for K's and Vᵀ's split planes, which the entry fills
            n_pad = _ceil_to(k.shape[1], F32_KEY_TILE)
            k_planes = torch.empty((2, b * h, n_pad, 64), device=q.device)
            vt_planes = torch.empty((2, b * h, 64, n_pad), device=q.device)
            err = _f32_lib().flash_attention_fwd_f32_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                tiles_ptr, k_planes.data_ptr(), vt_planes.data_ptr(),
                o.data_ptr(), lse.data_ptr(), b, n_q, k.shape[1], h, d,
                n_pad, *strides, float(scale), stream)
        else:
            err = _lib().flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if key_valid is None else key_valid.data_ptr(),
                o.data_ptr(), lse.data_ptr(), b, n_q, k.shape[1], h, d,
                *strides, float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed ({path}): "
                           f"error {err}")
    if key_valid is not None:
        launches_masked += 1
    elif d == NATURAL_HEAD_DIM:
        launches_natural += 1
    else:
        launches_unmasked += 1
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        key_valid: torch.Tensor | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) — the backward kernels on CUDA tensors, the plain
    version on CPU.  A masked call raises `NotImplementedError`."""
    global launches_backward, launches_backward_bf16
    global launches_backward_natural
    if key_valid is not None:
        raise NotImplementedError(
            "flash attention with key_valid has no backward: the JAX "
            "package's masked entry is forward-only, for the padded "
            "inference layout; train with the unpadded layout (remat=True)")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    d = q.shape[-1]
    _check(q, k, v, None)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not _loadable(do):           # an incoming gradient may be any view
        do = do.contiguous()
    _check_operand("dO", do, q)
    b, n_q, h, _ = q.shape
    n_k = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                  for x in (q, k, v))
    f32 = q.dtype == torch.float32
    path = route(q.dtype, d, False)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
               *dv.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path in ("wgmma", "fp32"):
            # LSE·log2(e) and δ padded to whole 128-row tiles: +∞ and 0 give
            # a padded query row P = 0 and dS = 0
            n_pad = _ceil_to(n_q, 128)
            lse2 = torch.full((b, h, n_pad), math.inf, device=q.device)
            lse2[..., :n_q] = lse * _LOG2E
            delta_p = torch.zeros((b, h, n_pad), device=q.device)
            delta_p[..., :n_q] = delta
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse2.data_ptr(), delta_p.data_ptr())
            outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        if path == "wgmma":
            err = _sm90_bwd_lib().flash_attention_bwd_sm90(
                *ptrs, *outs, b, n_q, n_k, h, d, n_pad, *strides,
                float(scale), stream)
        elif path == "fp32":
            # scratch for the split planes of Q, dO, K and V, which the
            # entry fills
            nk_pad = _ceil_to(n_k, F32_ROW_TILE)
            planes = torch.empty(2 * b * h * 64 * 2 * (n_pad + nk_pad),
                                 device=q.device)
            err = _f32_bwd_lib().flash_attention_bwd_f32_sm90(
                *ptrs, planes.data_ptr(), *outs, b, n_q, n_k, h, d, n_pad,
                nk_pad, *strides, float(scale), stream)
        else:
            err = _bwd_lib().flash_attention_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, n_q, n_k, h, d,
                *strides, float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed ({path}): "
                           f"error {err}")
    if f32:
        launches_backward += 1
    elif d == NATURAL_HEAD_DIM:
        launches_backward_natural += 1
    else:
        launches_backward_bf16 += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """O = softmax(scale·qkᵀ)·v through the kernels, differentiable: the
    forward saves q, k, v, O and the LSE for `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid=None, scale=None):
        o, lse = flash_attention_fwd(q, k, v, key_valid, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.key_valid, ctx.scale = key_valid, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.key_valid,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention output O only, differentiable through `FlashAttention`."""
    return FlashAttention.apply(q, k, v, key_valid, scale)
