"""The plain reference's softmax attention over (B, N, H, D): fp32 logits
and softmax, heads taken a few at a time so that the global attention of
the stitched decoder (1 × 13,520 keys, 16 heads) fits in fp32.  It stands
for the port's flash kernels (`ops/attention.py`'s dispatch)."""

from __future__ import annotations

import torch

HEADS_PER_CALL = 4


def plain_attention(q, k, v, *, scale=None, key_valid=None):
    """fp32 logits and softmax, probabilities cast to the input dtype for
    the PV product, fp32 accumulation."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    dtype = q.dtype
    outs = []
    for h0 in range(0, q.shape[2], HEADS_PER_CALL):
        hs = slice(h0, h0 + HEADS_PER_CALL)
        logits = torch.einsum("bnhd,bmhd->bhnm", q[:, :, hs].float(),
                              k[:, :, hs].float())
        if key_valid is not None:
            logits = logits.masked_fill(~key_valid, -1e30)
        probs = torch.softmax(logits * scale, dim=-1)
        del logits
        outs.append(torch.einsum("bhnm,bmhd->bnhd", probs.to(dtype).float(),
                                 v[:, :, hs].float()))
        del probs
    return torch.cat(outs, dim=2).to(dtype)
