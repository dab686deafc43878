"""FLOP counts of CogVideoX-5B from its configuration file's widths.

Like `flopcount.py`, the counts read `configs/<config>.json` (the `t2v`
group), never the program's dataclasses; the multiply-adds of matrix
products, convolutions and attention cores count 2 FLOP each;
normalisations, activations, RoPE and softmax are not counted.  A CPU test
holds them to `torch.utils.flop_counter` on the port's modules.
"""

from __future__ import annotations

from port_bench.flopcount import PEAK_BF16_FLOPS, ns  # noqa: F401


def latent_grid(t2v) -> tuple[int, int, int]:
    """(frames, h, w) of the CogVideoX latent."""
    return ((t2v.num_frames - 1) // 4 + 1, t2v.height // 8, t2v.width // 8)


def video_tokens(t2v) -> int:
    t, h, w = latent_grid(t2v)
    p = t2v.dit.patch_size
    return t * (h // p) * (w // p)


def joint_tokens(t2v) -> int:
    """The joint attention's sequence: T5's 226 tokens and the video's."""
    return t2v.t5.max_sequence_length + video_tokens(t2v)


def dit_forward_flops(t2v, batch: int = 1) -> float:
    """One DiT forward over `batch` latents: patchify, the text projection,
    the time embedding, the blocks (two modulations, q, k, v, o over the
    joint sequence, the attention core, the FFN), the head."""
    d = t2v.dit
    dim = d.num_attention_heads * d.attention_head_dim
    n, length = video_tokens(t2v), t2v.t5.max_sequence_length
    s = n + length
    patch = d.patch_size ** 2
    per = 2.0 * n * d.in_channels * patch * dim                   # patchify
    per += 2.0 * length * d.text_embed_dim * dim                  # text
    per += 2.0 * (dim * d.time_embed_dim + d.time_embed_dim ** 2)  # time
    block = (2.0 * 2 * d.time_embed_dim * 6 * dim                 # M, M′
             + 2.0 * s * dim * dim * 4                            # q k v o
             + 4.0 * s * s * dim                                  # core
             + 2.0 * s * dim * d.ffn_dim * 2)                     # FFN
    per += d.num_layers * block
    per += 2.0 * d.time_embed_dim * 2 * dim                       # AdaLN
    per += 2.0 * n * dim * d.out_channels * patch                 # head
    return batch * per


def cfg_step_flops(t2v) -> float:
    """One DDIM step with classifier-free guidance: the pair batched."""
    return dit_forward_flops(t2v, batch=2)


def attention_launches(t2v, forwards: int) -> dict:
    """The flash-attention launches of `forwards` DiT forwards, by the
    program's launch counter they should move: one joint attention a block
    (`launches_unmasked`, head_dim 64), each (count, B, N, H, D) with B = 2
    (the CFG pair) and N the joint sequence."""
    d = t2v.dit
    return {"flash_unmasked": [(d.num_layers * forwards, 2, joint_tokens(t2v),
                                d.num_attention_heads, d.attention_head_dim)]}
