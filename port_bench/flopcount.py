"""FLOP and byte counts from a configuration file's widths.

The counts read the numbers of `configs/<config>.json` (the `t23d` group),
never the program's dataclasses, so no change to the program moves them.
Each counts the multiply-adds of matrix products, convolutions and
attention cores as 2 FLOP (the MFU convention); normalisations,
activations, softmax and the render are not counted.  CPU tests hold them
to `torch.utils.flop_counter` on the port's modules.
"""

from __future__ import annotations

import math
import re
from types import SimpleNamespace

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3


def ns(d):
    """A configuration group as attributes (the copied counts read
    `cfg.encoder.agg.patch_size` and the like)."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: ns(v) for k, v in d.items()})
    return d


def latent_grid(t23d) -> tuple[int, int, int]:
    """(frames, h, w) of the Wan latent."""
    return ((t23d.num_frames - 1) // 4 + 1, t23d.height // 8,
            t23d.width // 8)


def dit_tokens(t23d) -> int:
    t, h, w = latent_grid(t23d)
    pt, ph, pw = t23d.dit.patch_size
    return (t // pt) * (h // ph) * (w // pw)


def dit_forward_flops(t23d, batch: int = 1) -> float:
    """One Wan DiT forward over `batch` latents, text of the UMT5 padding
    length: patchify, time and text embedders, the blocks (self-attention
    with a fused QKV, cross-attention to the text, the MLP), the head."""
    d = t23d.dit
    n, length = dit_tokens(t23d), t23d.umt5.max_sequence_length
    dim, ffn = d.dim, d.ffn_dim
    patch = math.prod(d.patch_size)
    per = 2.0 * n * d.in_channels * patch * dim                 # patchify
    per += 2.0 * (d.freq_dim * dim + dim * dim + dim * 6 * dim)  # time
    per += 2.0 * length * (d.text_dim * dim + dim * dim)         # text
    block = (2.0 * n * dim * 3 * dim + 2.0 * n * dim * dim       # qkv, o
             + 4.0 * n * n * dim                                 # attn core
             + 2.0 * n * dim * dim * 2                           # x-attn q, o
             + 2.0 * length * dim * dim * 2                      # x-attn k, v
             + 4.0 * n * length * dim                            # x-attn core
             + 2.0 * n * dim * ffn * 2)                          # MLP
    per += d.num_layers * block
    per += 2.0 * n * dim * d.out_channels * patch                # head
    return batch * per


def cfg_step_flops(t23d) -> float:
    """One UniPC step with classifier-free guidance: the pair batched."""
    return dit_forward_flops(t23d, batch=2)


def umt5_flops(t23d, prompts: int = 2) -> float:
    """UMT5 encoder over `prompts` sequences of the padding length:
    q, k, v, o, the attention core and the gated-GELU MLP per layer."""
    u = t23d.umt5
    n, d, inner = u.max_sequence_length, u.d_model, u.num_heads * u.d_kv
    layer = (2.0 * n * d * inner * 4 + 4.0 * n * n * inner
             + 2.0 * n * d * u.d_ff * 3)
    return prompts * u.num_layers * layer


def _conv(ci, co, k, out_elems) -> float:
    return 2.0 * ci * co * math.prod(k) * out_elems


def vae_decode_flops(t23d) -> float:
    """The Wan VAE decoder on one latent: post-quant conv, conv_in, the mid
    block (two residual blocks around single-head spatial attention), the
    up blocks with their resamples, conv_out."""
    v = t23d.vae
    t, h, w = latent_grid(t23d)
    m = tuple(v.dim_mult)
    dims = [v.base_dim * u for u in (m[-1],) + m[::-1]]
    up_t = tuple(v.temperal_downsample)[::-1]
    fl = _conv(v.z_dim, v.z_dim, (1, 1, 1), t * h * w)
    fl += _conv(v.z_dim, dims[0], (3, 3, 3), t * h * w)

    def res(ci, co, t, h, w):
        f = _conv(ci, co, (3, 3, 3), t * h * w) \
            + _conv(co, co, (3, 3, 3), t * h * w)
        if ci != co:
            f += _conv(ci, co, (1, 1, 1), t * h * w)
        return f

    c = dims[0]
    fl += 2 * res(c, c, t, h, w)
    fl += t * (_conv(c, 3 * c, (1, 1), h * w) + _conv(c, c, (1, 1), h * w)
               + 4.0 * (h * w) ** 2 * c)
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        if i > 0:
            ci //= 2
        for j in range(v.num_res_blocks + 1):
            fl += res(ci if j == 0 else co, co, t, h, w)
        if i != len(m) - 1:
            if up_t[i] and t > 1:
                fl += _conv(co, 2 * co, (3, 1, 1), (t - 1) * h * w)
                t = 1 + 2 * (t - 1)
            h, w = 2 * h, 2 * w
            fl += _conv(co, co // 2, (3, 3), t * h * w)
    fl += _conv(dims[-1], 3, (3, 3, 3), t * h * w)
    return fl


def _conv_spec(spec: str) -> tuple[tuple[int, ...], int]:
    """'conv3d_k5x3x3_o1024_s1x2x2_p2x1x1' → ((5, 3, 3), 1024)."""
    k = tuple(int(x) for x in re.search(r"_k([\dx]+)", spec)[1].split("x"))
    return k, int(re.search(r"_o(\d+)", spec)[1])


def stitched_flops(stitched, size: int, s: int) -> float:
    """The stitched decoder on S frames of `size`² feed-forward images:
    copied from the JAX package's `bench.py::_flops` (matmuls, attention
    cores, convs, resize contractions), with the stitch conv's kernel read
    from its spec string."""
    e = stitched.encoder
    h = w = size
    ph, pw = h // e.agg.patch_size, w // e.agg.patch_size
    p = 1 + e.agg.num_register_tokens + ph * pw     # tokens per frame
    c = e.agg.embed_dim

    def block_matmul(n, dim, ratio):
        return (8.0 + 4.0 * ratio) * n * dim * dim

    def attn_core(n, dim):
        return 4.0 * n * n * dim

    vit_blocks = e.vit.depth - stitched.stitch_layer_index
    pairs = e.agg.depth
    trunk = ((vit_blocks + 2 * pairs) * block_matmul(s * p, c, e.agg.mlp_ratio)
             + (vit_blocks + pairs) * s * attn_core(p, c)
             + pairs * attn_core(s * p, c))
    k, out = _conv_spec(stitched.conv_spec)
    stitch = 2.0 * out * stitched.latent_channels * math.prod(k) \
        * s * ph * pw
    cam = e.camera.num_iterations * e.camera.trunk_depth * block_matmul(
        s, e.camera.dim_in, e.camera.mlp_ratio)
    heads = s * (dpt_flops(e.depth, h, w) + dpt_flops(e.gs, h, w,
                                                      rgb_skip=True))
    return trunk + stitch + cam + heads


def dpt_flops(cfg, h: int, w: int, *, rgb_skip: bool = False) -> float:
    """Per-frame conv and resize FLOP of one DPT head: copied from the JAX
    package's `bench.py::_dpt_flops`."""
    ph, pw = h // cfg.patch_size, w // cfg.patch_size
    g = ph * pw
    f, oc, c2 = cfg.features, cfg.out_channels, cfg.features // 2
    fl = sum(2.0 * cfg.dim_in * o * g for o in oc)
    fl += 2.0 * 16 * oc[0] ** 2 * g
    fl += 2.0 * 4 * oc[1] ** 2 * g
    fl += 2.0 * 9 * oc[3] ** 2 * (g // 4)
    scales = (16 * g, 4 * g, g, g // 4)
    fl += sum(2.0 * 9 * oc[i] * f * scales[i] for i in range(4))
    for n_res, s_in, s_out in ((2, g // 4, g), (4, g, 4 * g),
                               (4, 4 * g, 16 * g), (4, 16 * g, 64 * g)):
        fl += n_res * 2.0 * 9 * f * f * s_in + 2.0 * f * f * s_out
    fl += 2.0 * 9 * f * c2 * 64 * g
    fl += 2.0 * h * (8 * ph) * (8 * pw) * c2 + 2.0 * w * h * (8 * pw) * c2
    if rgb_skip:
        fl += 2.0 * 49 * 3 * c2 * h * w
    fl += 2.0 * 9 * c2 * cfg.head2_features * h * w
    fl += 2.0 * cfg.head2_features * cfg.output_dim * h * w
    return fl


def scene_flops(t23d) -> float:
    """One text→3DGS scene as counted for `mfu.scene`: UMT5 over the two
    prompts, the denoise's CFG steps, the VAE decode and the stitched
    decoder.  The render is not counted: its work depends on the data."""
    s = t23d.num_frames
    return (umt5_flops(t23d) + t23d.num_inference_steps * cfg_step_flops(t23d)
            + vae_decode_flops(t23d)
            + stitched_flops(t23d.stitched, t23d.feedforward_size, s))


def attention_bound_s(b: int, n: int, h: int, d: int,
                      bytes_per: int = 2) -> float:
    """The least time of one forward attention launch on (B, N, H, D) bf16
    q, k, v: the larger of 4·N²·D·H·B FLOP at the bf16 peak and the bytes
    of q, k, v read once and o written once at the HBM peak."""
    flops = 4.0 * n * n * d * h * b
    nbytes = 4.0 * b * n * h * d * bytes_per
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def scene_attention_launches(t23d) -> dict:
    """The flash-attention launches one scene makes, by the program's
    launch counter they should move, each (count, B, N, H, D) at the
    sizes the algorithm needs (no padding): the DiT's self-attention
    (`launches_natural`: B = 2, the CFG pair), the chopped ViT's blocks
    (`launches_unmasked`), and the aggregator's frame and global attention
    (`launches_masked`)."""
    return {"flash_natural": denoise_attention_launches(t23d)["flash_natural"],
            **decoder_attention_launches(t23d.stitched, t23d.feedforward_size,
                                         t23d.num_frames)}


def denoise_attention_launches(t23d) -> dict:
    d = t23d.dit
    return {"flash_natural": [(d.num_layers * t23d.num_inference_steps, 2,
                               dit_tokens(t23d), d.num_heads,
                               d.dim // d.num_heads)]}


def decoder_attention_launches(stitched, size: int, s: int) -> dict:
    e = stitched.encoder
    g = (size // e.agg.patch_size) ** 2
    p_vit = 1 + e.vit.num_register_tokens + g
    p_agg = 1 + e.agg.num_register_tokens + g
    hv, dv = e.vit.num_heads, e.vit.embed_dim // e.vit.num_heads
    ha, da = e.agg.num_heads, e.agg.embed_dim // e.agg.num_heads
    return {"flash_unmasked": [(e.vit.depth - stitched.stitch_layer_index,
                                s, p_vit, hv, dv)],
            "flash_masked": [(e.agg.depth, s, p_agg, ha, da),
                             (e.agg.depth, 1, s * p_agg, ha, da)]}


def launches_bound_s(launches: dict) -> float:
    return sum(c * attention_bound_s(b, n, h, d)
               for shapes in launches.values() for c, b, n, h, d in shapes)
