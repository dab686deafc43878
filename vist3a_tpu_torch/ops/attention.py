"""Attention dispatch: the Hopper flash kernel, or plain PyTorch math.

Port of `vist3a_tpu/ops/attention.py`.  q, k, v are (B, N, H, D).  The rule
is the JAX package's: with impl "auto", a CUDA tensor whose sequence is at
least 1024 long goes to the flash-attention kernel (masked when key_valid is
given), and that call launches the kernel or raises — it never falls back.
Everything else, every CPU tensor and every short sequence (the camera
head's N = S, whose blocks ask for impl "plain" like the JAX "xla"), runs
the plain math of `_xla_attention`.
"""

from __future__ import annotations

import torch

from vist3a_tpu_torch.kernels.flash_attention import flash_attention

FLASH_MIN_SEQ = 1024


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, impl: str = "auto", scale: float | None = None,
                          key_valid: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Softmax attention over (B, N, H, D), fp32 softmax.

    key_valid: optional (N_k,) bool — masked keys get −1e30 logits."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if impl == "auto" and q.is_cuda and q.shape[1] >= FLASH_MIN_SEQ:
        return flash_attention(q, k, v, key_valid, scale)
    return plain_attention(q, k, v, scale=scale, key_valid=key_valid)


def plain_attention(q, k, v, *, scale=None, key_valid=None):
    """`_xla_attention`: fp32 logits and softmax, probabilities cast to the
    input dtype for the PV product, fp32 accumulation."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    dtype = q.dtype
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    if key_valid is not None:
        logits = logits.masked_fill(~key_valid, -1e30)
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)
