"""The port's CUDA kernels on the card (marker `gpu`; skips without one).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest imports JAX.)  Inputs are made on the
card from a seeded generator, or with numpy from a seed by
`tests/raster_cases.py` and `tests/export_cases.py` (torch and the port
only).
"""

import export_cases
import numpy as np
import pytest
import raster_cases
import torch

from chip_smoke import (QK_CASES, RASTER_ATOL, RASTER_BWD_MAX_OFF_SHARE,
                        RASTER_BWD_MAX_REL, RASTER_BWD_RTOL,
                        RASTER_MAX_OFF_SHARE, compare_qk_prologue)
from vist3a_tpu_torch.io import video_export
from vist3a_tpu_torch.kernels import flash_attention as fa
from vist3a_tpu_torch.kernels import qk_prologue as qkp
from vist3a_tpu_torch.kernels import rasterizer as tr
from vist3a_tpu_torch.nn import wan_dit
from vist3a_tpu_torch.ops.attention import dot_product_attention

# The bf16 kernel against the fp32 plain version, elementwise:
# |ΔO| ≤ O_ATOL_STD · std(O_ref) + O_RTOL · |O_ref|, as in chip_smoke.py,
# which states why: O is a softmax average whose scale falls with N, so a
# fixed limit would be loose at large N; both sides store O in bf16 (one
# step, up to 2⁻⁷·|O|), and the kernel rounds P to bf16 before PV.
O_ATOL_STD = 0.1
O_RTOL = 2 ** -6


def _o_ok(o, o_ref) -> bool:
    ref = o_ref.float()
    limit = O_ATOL_STD * ref.std() + O_RTOL * ref.abs()
    return bool(((o.float() - ref).abs() <= limit).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # fp32 matmuls and convolutions in full fp32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,d,n_pad", [
    (2, 1029, 4, 64, 0), (2, 1040, 4, 64, 11), (1, 333, 3, 128, 7),
    (1, 77, 2, 40, 0), (2, 130, 2, 64, 130), (2, 1100, 2, 40, 0),
    (2, 1100, 2, 96, 7)])
def test_kernel_matches_ref_on_card(cuda, b, n, h, d, n_pad):
    """bf16 kernel against the fp32 plain version on the same bf16 inputs:
    O within O_ATOL_STD of its std plus O_RTOL of itself (P is rounded to
    bf16 before the PV product, O to bf16 on store; a fully masked row is
    exactly 0), LSE within 1e-3 (fp32 statistics, summation order only)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, n, h, d, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    kv = (torch.arange(n, device=cuda) < n - n_pad) if n_pad else None
    before = fa.launches_unmasked + fa.launches_masked
    o, lse = fa.flash_attention_fwd(q, k, v, kv)
    torch.cuda.synchronize()
    assert fa.launches_unmasked + fa.launches_masked == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, kv)
    assert _o_ok(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_kernel_reads_strided_views_in_place(cuda):
    """q, k, v as views into one (B, N, 3, H, D) tensor, as the attention
    sublayer hands them over."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 1100, 3, 4, 64, generator=gen, device=cuda
                      ).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, _ = fa.flash_attention_fwd(q, k, v)
    o_ref, _ = fa.flash_attention_ref(q, k, v)
    assert _o_ok(o, o_ref)


@pytest.mark.gpu
def test_dispatch_raises_instead_of_falling_back(cuda):
    """N ≥ 1024 on the card selects the kernel; fp64 inputs raise there,
    and a short sequence takes the plain math without a launch."""
    x = torch.zeros(1, 1024, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        dot_product_attention(x, x, x)
    before = fa.launches_unmasked + fa.launches_masked
    short = torch.zeros(1, 1023, 2, 64, device=cuda, dtype=torch.bfloat16)
    dot_product_attention(short, short, short)
    assert fa.launches_unmasked + fa.launches_masked == before


# The fp32 kernels against the plain version (both fp32, sums in another
# order over up to a few thousand keys here): O within 2e-5 of its largest
# magnitude, the three gradients within 1e-4 of theirs (each sums twice as
# many products: a dS term, then a tile loop), LSE within 1e-5.
F32_O_RTOL = 2e-5
F32_GRAD_RTOL = 1e-4
F32_LSE_ATOL = 1e-5


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h", [(2, 1100, 2), (1, 45, 3), (2, 1029, 4)])
def test_fp32_kernels_match_ref_on_card(cuda, b, n, h):
    """The fp32 forward and the backward (kernel 4) at ragged N (1100 and
    1029 are no multiples of the 64-row tiles, 45 is less than one), each a
    launch of its counter; the backward gives the same bits twice (no
    atomics), and autograd through the dispatch reaches it."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(b, n, h, 64, generator=gen, device=cuda)
                   for _ in range(4))
    before = (fa.launches_unmasked, fa.launches_backward)
    o, lse = fa.flash_attention_fwd(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.launches_unmasked, fa.launches_backward) == (
        before[0] + 1, before[1] + 1)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    assert _rel(o, o_ref) <= F32_O_RTOL
    assert (lse - lse_ref).abs().max().item() <= F32_LSE_ATOL
    refs = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do)
    for got, want in zip(grads, refs):
        assert _rel(got, want) <= F32_GRAD_RTOL
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    if n >= 1024:
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        dot_product_attention(*leaves).backward(do)
        for leaf, want in zip(leaves, grads):
            assert torch.equal(leaf.grad, want)


@pytest.mark.gpu
def test_backward_raises_without_a_kernel(cuda):
    """A grad-requiring call whose backward has no kernel — a masked call,
    bf16 or fp32 — raises in the backward instead of dropping the gradient;
    the unmasked bf16 calls (either head dim) have their kernels and give
    gradients."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    mask = torch.ones(1100, device=cuda, dtype=torch.bool)
    for dtype, d, kv in ((torch.bfloat16, 64, None),
                         (torch.bfloat16, 128, None),
                         (torch.bfloat16, 64, mask),
                         (torch.float32, 64, mask)):
        q = torch.randn(1, 1100, 2, d, generator=gen, device=cuda
                        ).to(dtype).requires_grad_()
        o = dot_product_attention(q, q, q, key_valid=kv)
        assert o.grad_fn is not None
        if kv is None:
            o.float().sum().backward()
            assert q.grad is not None and bool(torch.isfinite(q.grad).all())
            continue
        with pytest.raises(NotImplementedError):
            o.float().sum().backward()


def _counts():
    return (fa.launches_unmasked, fa.launches_masked, fa.launches_natural)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h", [(2, 1100, 2), (1, 4096, 3)])
def test_natural_kernel_matches_ref_on_card(cuda, b, n, h):
    """An unmasked D = 128 call (the natural-layout entry of the JAX
    package) against the fp32 plain version on the same bf16 inputs, ragged
    N (1100 is no multiple of the 64-key tile): O and LSE within the
    limits of the other entries.  It counts as natural, the
    dispatch sends it there, and D = 64 still counts as unmasked."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(b, n, h, 128, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    before = _counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 1)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    assert _o_ok(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    got = dot_product_attention(q, k, v)
    assert _counts() == (before[0], before[1], before[2] + 2)
    assert torch.equal(got, o)
    fa.flash_attention_fwd(*(x[..., :64].contiguous() for x in (q, k, v)))
    assert _counts() == (before[0] + 1, before[1], before[2] + 2)


@pytest.mark.gpu
def test_dit_forward_launches_the_natural_kernel_once_per_layer(cuda):
    """A narrow DiT at 4096 tokens: each block's self-attention launches
    the natural entry once; the cross-attention over the text runs plain
    math and launches nothing."""
    cfg = wan_dit.WanDiTConfig(dim=256, ffn_dim=512, num_layers=3,
                               num_heads=2, text_dim=64, freq_dim=32)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dit = wan_dit.init(cfg, gen, device=cuda, dtype=torch.bfloat16)
    latent = torch.randn(2, 16, 4, 64, 64, generator=gen, device=cuda
                         ).to(torch.bfloat16)
    text = torch.randn(2, 226, 64, generator=gen, device=cuda
                       ).to(torch.bfloat16)
    before = _counts()
    out = wan_dit.forward(dit, latent, torch.tensor([999.0, 10.0],
                                                    device=cuda), text)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + cfg.num_layers)
    assert out.shape == latent.shape and bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    *QK_CASES,
    # odd shapes: a width of one warp's columns, rows no power of two
    ("qk_narrow", 3, 77, 256, 2, 3, True),
    ("qk_narrow_cross", 2, 45, 1024, 8, 1, False)])
def test_qk_prologue_matches_plain_on_card(cuda, case):
    """The q/k prologue kernel against its plain version on the same
    inputs (`chip_smoke.compare_qk_prologue`): one launch, contiguous
    outputs, each normed part within `QK_MAX_ULPS` before RoPE and rotated
    bit for bit as `apply_rope` rotates it, each bias-only part bit-equal;
    an fp32 call raises instead of launching."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    res, passed, (args, _) = compare_qk_prologue(case, gen)
    assert passed, res
    x, biases, scales, eps, head_dim, rope = args
    with pytest.raises(TypeError, match="bf16"):
        qkp.qk_prologue(x.float(), biases, scales, eps, head_dim, rope)


@pytest.mark.gpu
def test_dit_forward_launches_the_qk_prologue_three_times_per_layer(cuda):
    """A narrow DiT at 4096 tokens: in inference each block launches the
    q/k prologue three times (self q/k/v, cross q, cross k) and its output
    matches the torch ops' (the training entry with grad enabled, which
    launches none) within the DiT card tolerance of `reference_dit`."""
    cfg = wan_dit.WanDiTConfig(dim=256, ffn_dim=512, num_layers=3,
                               num_heads=2, text_dim=64, freq_dim=32)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dit = wan_dit.init(cfg, gen, device=cuda, dtype=torch.bfloat16)
    latent = torch.randn(2, 16, 4, 64, 64, generator=gen, device=cuda
                         ).to(torch.bfloat16)
    text = torch.randn(2, 226, 64, generator=gen, device=cuda
                       ).to(torch.bfloat16)
    ts = torch.tensor([999.0, 10.0], device=cuda)
    before = qkp.launches
    out = wan_dit.forward(dit, latent, ts, text)
    torch.cuda.synchronize()
    assert qkp.launches == before + 3 * cfg.num_layers
    with torch.enable_grad():
        ref = wan_dit.forward(dit, latent, ts, text, remat=True)
    torch.cuda.synchronize()
    assert qkp.launches == before + 3 * cfg.num_layers
    diff = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert diff.item() <= 2 ** -5


def _splat_scene(g: int, w: int, h: int, device, seed: int):
    """Random splats in front of an identity camera, most of them visible,
    opacities up to 0.99 so that many pixels reach the 1e-4 stop."""
    gen = torch.Generator(device=device).manual_seed(seed)
    means = torch.randn(g, 3, generator=gen, device=device) * 0.6
    means[:, 2] += 4.0
    a = torch.randn(g, 3, 3, generator=gen, device=device) * 0.08
    covars = a @ a.transpose(1, 2) + 1e-3 * torch.eye(3, device=device)
    harm = torch.randn(g, 3, 25, generator=gen, device=device) * 0.3
    op = torch.rand(g, generator=gen, device=device) * 0.69 + 0.3
    viewmat = torch.eye(4, device=device)
    K = torch.tensor([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                     device=device)
    return means, covars, harm, op, viewmat, K


@pytest.mark.gpu
@pytest.mark.parametrize("g,w,h,budget", [
    (2000, 64, 64, 1 << 16), (1500, 72, 40, 1 << 16), (3000, 64, 64, 2048)])
def test_composite_kernel_matches_plain_on_card(cuda, g, w, h, budget):
    """The kernel against `composite_ref` on the same pair stream: every
    plane within 1e-5 (fp32, sums in another order) on all but 0.5 % of
    the pixels, where the 1e-4 stop may fire one pair apart (the plain
    version's cumprod is a parallel scan on the card); a budget of 2048
    truncates the stream; 72×40 is no multiple of the tile."""
    means, covars, harm, op, viewmat, K = _splat_scene(g, w, h, cuda, g)
    table, pairs = tr.view_pairs(means, covars, harm, op, viewmat, K, w, h,
                                 budget)
    assert (pairs.total > pairs.gid.numel()) == (budget == 2048)
    ntx = -(-w // tr.TILE)
    before = tr.launches
    img = tr.composite(pairs.gid, pairs.bounds, table, ntx, w, h)
    torch.cuda.synchronize()
    assert tr.launches == before + 1
    ref = tr.composite_ref(pairs.gid, pairs.bounds, table, ntx, w, h)
    assert img.shape == ref.shape == (6, h, w)
    assert bool(torch.isfinite(img).all())
    off = ((img - ref).abs() > 1e-5 + 1e-5 * ref.abs()).any(0)
    assert off.float().mean().item() <= 0.005
    assert float(img[4].max()) > 0.5          # the splats cover pixels


@pytest.mark.gpu
@pytest.mark.parametrize("case", export_cases.CASES)
def test_orbit_uint8_frames_on_card_equal_the_numpy_paths(cuda, case):
    """The export's frames made on the card at the scene's orbit (133 views
    at 448², every 13th a key frame), byte for byte the numpy functions':
    CUDA divides by a host scalar as a multiply by its reciprocal, which
    the bin_edges case shows."""
    color, depth = export_cases.orbit(case, (133, 448, 448), seed=21)
    gs, dep = video_export.orbit_uint8_frames(
        torch.from_numpy(color).to(cuda), torch.from_numpy(depth).to(cuda),
        13)
    np.testing.assert_array_equal(gs, video_export.to_uint8_frames(color))
    np.testing.assert_array_equal(dep, video_export.to_uint8_frames(
        video_export.turbo_depth(depth, 13)))


@pytest.mark.gpu
def test_rasterize_launches_once_per_view(cuda):
    means, covars, harm, op, viewmat, K = _splat_scene(500, 48, 48, cuda, 7)
    vms = torch.stack([viewmat, viewmat, viewmat])
    vms[1, 0, 3] = -0.4
    tr.reset_launch_counts()
    rgb, dep, alp = tr.rasterize(means, covars, harm, op, vms,
                                 torch.stack([K, K, K]), 48, 48)
    torch.cuda.synchronize()
    assert tr.launches == 3
    assert rgb.shape == (3, 48, 48, 3) and bool(torch.isfinite(rgb).all())
    with pytest.raises(TypeError, match="int32"):
        tr.composite(torch.zeros(4, dtype=torch.int64, device=cuda),
                     torch.zeros(10, dtype=torch.int32, device=cuda),
                     torch.zeros(8, tr.N_ATTR, device=cuda), 3, 48, 48)


# The bf16 backward (kernels 4b and 5) against the plain version, each
# gradient elementwise within GRAD_ATOL_STD·std + GRAD_RTOL·|ref|, as in
# chip_smoke.py, which states why.
GRAD_ATOL_STD = 0.05
GRAD_RTOL = 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,d", [(2, 1100, 2, 64), (1, 45, 3, 64),
                                     (1, 4096, 2, 128), (2, 333, 3, 128),
                                     (2, 333, 3, 48)])
def test_bf16_backward_matches_plain_on_card(cuda, b, n, h, d):
    """The bf16 backward kernel against the plain version on the card, bit
    for bit repeatable, counted by head dim."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    q, k, v, do = (torch.randn(b, n, h, d, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    before = (fa.launches_backward_bf16, fa.launches_backward_natural)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    grew = (fa.launches_backward_bf16 - before[0],
            fa.launches_backward_natural - before[1])
    assert grew == ((0, 1) if d == 128 else (1, 0))
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        w = w.float()
        limit = GRAD_ATOL_STD * w.std() + GRAD_RTOL * w.abs()
        assert bool(((g.float() - w).abs() <= limit).all())
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,strided", [
    (2, 1100, 2, False), (1, 45, 3, False), (1, 4096, 2, False),
    (2, 1100, 4, True)])
def test_wgmma_kernels_match_plain_on_card(cuda, b, n, h, strided):
    """The wgmma + TMA forward and backward (bf16, unmasked, head_dim 128)
    against the plain versions: ragged N (1100 is no multiple of the
    128-row tiles), N below one tile, and q, k, v as views into one
    (B, N, 3, H, 128) tensor, read in place.  O and LSE within the limits
    of the other forward cases, each gradient within the `GRAD_*` limit,
    the backward the same bits twice; each call counts as the natural
    entry."""
    gen = torch.Generator(device=cuda).manual_seed(n + h)
    if strided:
        qkv = torch.randn(b, n, 3, h, 128, generator=gen, device=cuda
                          ).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(b, n, h, 128, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(3))
    do = torch.randn(b, n, h, 128, generator=gen, device=cuda
                     ).to(torch.bfloat16)
    assert fa.route(q.dtype, 128, False) == "wgmma"
    before = (fa.launches_natural, fa.launches_backward_natural)
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.launches_natural, fa.launches_backward_natural) == (
        before[0] + 1, before[1] + 1)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    assert _o_ok(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        w = w.float()
        limit = GRAD_ATOL_STD * w.std() + GRAD_RTOL * w.abs()
        assert bool(((g.float() - w).abs() <= limit).all())
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _frame_mask(n: int, kind: str, device):
    """Key validity: `frame` 11 dead keys ending each 1,040-key frame (the
    stitched decoder's padded layout), `all` none live."""
    idx = torch.arange(n, device=device)
    return idx % 1040 < 1029 if kind == "frame" else idx < 0


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,mask,strided", [
    (2, 1100, 2, None, False), (1, 45, 3, None, False),
    (2, 1040, 4, "frame", False), (1, 4160, 2, "frame", False),
    (2, 130, 2, "all", False), (2, 1100, 4, None, True),
    (2, 1040, 4, "frame", True)])
def test_wgmma_d64_kernels_match_plain_on_card(cuda, b, n, h, mask, strided):
    """The wgmma + TMA forward at head_dim 64, masked and unmasked, and its
    backward (unmasked calls only: a masked call has none) against the
    plain versions: ragged N (1100 is no multiple of the 128-row tiles), N
    below one tile, dead keys inside tiles (four 1,040-key frames hold 11
    dead keys each), every key dead (O = 0, LSE the sentinel), and q, k, v
    as views into one (B, N, 3, H, 64) tensor, read in place.  O and LSE
    within the limits of the other forward cases, each gradient within the
    `GRAD_*` limit, the backward the same bits twice; the forward counts
    as the masked or the unmasked entry, the backward as kernel 4b."""
    gen = torch.Generator(device=cuda).manual_seed(n + h)
    if strided:
        qkv = torch.randn(b, n, 3, h, 64, generator=gen, device=cuda
                          ).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(b, n, h, 64, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(3))
    kv = None if mask is None else _frame_mask(n, mask, cuda)
    assert fa.route(q.dtype, 64, kv is not None) == "wgmma"
    before = (fa.launches_unmasked, fa.launches_masked,
              fa.launches_backward_bf16)
    o, lse = fa.flash_attention_fwd(q, k, v, kv)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, kv)
    assert _o_ok(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    if mask == "all":
        assert not bool(o.any())
    if kv is not None:
        assert (fa.launches_unmasked, fa.launches_masked,
                fa.launches_backward_bf16) == (
            before[0], before[1] + 1, before[2])
        return
    do = torch.randn(b, n, h, 64, generator=gen, device=cuda
                     ).to(torch.bfloat16)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.launches_unmasked, fa.launches_masked,
            fa.launches_backward_bf16) == (before[0] + 1, before[1],
                                           before[2] + 1)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        w = w.float()
        limit = GRAD_ATOL_STD * w.std() + GRAD_RTOL * w.abs()
        assert bool(((g.float() - w).abs() <= limit).all())
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _card_scene(device, g=2000, seed=5):
    gen = torch.Generator().manual_seed(seed)
    means = torch.randn(g, 3, generator=gen) * 0.6
    means[:, 2] += 4.0
    a = torch.randn(g, 3, 3, generator=gen) * 0.08
    covars = a @ a.transpose(1, 2) + 1e-3 * torch.eye(3)
    harm = torch.randn(g, 3, 16, generator=gen) * 0.3
    op = torch.rand(g, generator=gen) * 0.69 + 0.3
    vms = torch.eye(4).repeat(2, 1, 1)
    vms[1, 0, 3] = -0.3
    K = torch.tensor([[58.0, 0, 32], [0, 58.0, 32], [0, 0, 1]]).repeat(2, 1, 1)
    return [x.to(device) for x in (means, covars, harm, op, vms, K)]


@pytest.mark.gpu
def test_rasterize_gradients_on_card_match_cpu(cuda):
    """The repaired fault: on the card `rasterize` returns images with a
    `grad_fn`, and the Gaussians' gradients (through the composite
    backward kernel, one launch a view, plus one recompute forward a view)
    equal the CPU's."""
    def grads(device, remat):
        scene = _card_scene(device)
        leaves = [x.clone().requires_grad_() for x in scene[:4]]
        out = tr.rasterize(*leaves, scene[4], scene[5], 64, 64,
                           remat_views=remat)
        assert all(x.grad_fn is not None for x in out)
        loss = sum((x * x).sum() for x in out)
        return [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    want = grads("cpu", False)
    tr.reset_launch_counts()
    got = grads(cuda, True)
    torch.cuda.synchronize()
    assert (tr.launches, tr.launches_backward) == (4, 2)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4


@pytest.mark.gpu
def test_composite_backward_matches_plain_on_card(cuda):
    scene = _card_scene(cuda)
    table, pairs = tr.view_pairs(*scene[:4], scene[4][0], scene[5][0], 64,
                                 64, 1 << 16)
    out = tr.composite(pairs.gid, pairs.bounds, table, 4, 64, 64)
    gout = torch.randn(6, 64, 64, device=cuda)
    got = tr.composite_bwd(pairs.gid, pairs.bounds, table, out, gout, 4, 64,
                           64)
    again = tr.composite_bwd(pairs.gid, pairs.bounds, table, out, gout, 4,
                             64, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = tr.composite_bwd_ref(pairs.gid, pairs.bounds, table, out, gout,
                                4, 64, 64)
    scale = want.abs().amax(0).clamp_min(1e-30)
    off = ((got - want).abs() > 1e-4 * scale).any(1)
    assert off.float().mean().item() <= 0.005
    # a pixel stopping one pair apart moves a row by about one pair's
    # weight; a fault in dα (the T_final cotangent dropped) moves the few
    # rows it touches by a large share of their column
    assert bool(((got - want).abs().amax(0) <= 1e-2 * scale).all())


# The composites against their plain versions, with chip_smoke.py's limits
# (it states why): each plane within RASTER_ATOL of its scale on all but
# RASTER_MAX_OFF_SHARE of the pixels; each gradient row within
# RASTER_BWD_RTOL of its column's largest on all but
# RASTER_BWD_MAX_OFF_SHARE of the pairs, and every error within
# RASTER_BWD_MAX_REL of it.
RASTER_CASES = {
    # grazing ellipses, needles, non-PD conics, huge radii and an opaque
    # cluster, at a size no multiple of the tile (72×40) and at 48²
    "grazing_72x40": lambda: raster_cases.grazing_case(2, exact=False),
    "grazing_48": lambda: raster_cases.grazing_case(3, 48, 48, exact=False),
    # every tile walks 3000 pairs: over ten stages of either kernel
    "long_segment": lambda: raster_cases.long_segment_case(0),
    # every pixel stops within the first stage, 2000 pairs follow
    "early_stop": lambda: raster_cases.early_stop_case(0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(RASTER_CASES))
def test_composite_kernels_match_plain_on_hard_cases(cuda, name):
    """The culled, staged walk of both kernels on the cases that stress it:
    the forward and the backward within the RASTER_* limits, the backward
    the same bits twice, one launch each."""
    case = RASTER_CASES[name]().to(cuda)
    args = (case.gid, case.bounds, case.table, case.ntx, case.width,
            case.height)
    before = (tr.launches, tr.launches_backward)
    img = tr.composite(*args)
    torch.cuda.synchronize()
    ref = tr.composite_ref(*args)
    assert bool(torch.isfinite(img).all())
    scale = ref.abs().flatten(1).amax(1).clamp_min(1.0)[:, None, None]
    off = ((img - ref).abs() > RASTER_ATOL * scale).any(0)
    assert off.float().mean().item() <= RASTER_MAX_OFF_SHARE
    assert float(ref[4].max()) > 0.5

    gen = torch.Generator(device=cuda).manual_seed(11)
    gout = torch.randn(ref.shape, generator=gen, device=cuda)
    got = tr.composite_bwd(*args[:3], ref, gout, *args[3:])
    again = tr.composite_bwd(*args[:3], ref, gout, *args[3:])
    torch.cuda.synchronize()
    assert (tr.launches, tr.launches_backward) == (before[0] + 1,
                                                   before[1] + 2)
    assert torch.equal(got, again)
    want = tr.composite_bwd_ref(*args[:3], ref, gout, *args[3:])
    scale = want.abs().amax(0).clamp_min(1e-30)
    diff = (got - want).abs()
    assert (diff > RASTER_BWD_RTOL * scale).any(1).float().mean().item() \
        <= RASTER_BWD_MAX_OFF_SHARE
    assert bool((diff.amax(0) <= RASTER_BWD_MAX_REL * scale).all())
