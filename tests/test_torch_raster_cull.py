"""The composite kernels' cull mask (`csrc/raster_common.cuh::subtile_mask`)
through its plain version `rasterizer.subtile_mask_ref`, on the CPU.

Both composite kernels give warp w of a tile's block the 8×4 sub-tile
w = 2·(y // 4) + x // 8 and walk it only over the pairs whose mask holds
bit w.  That is exact only if every (pixel, pair) the composite lets
through (σ ≥ 0 and a_raw ≥ 1/255) lies in a sub-tile whose bit is set.
Held here:
  * coverage, with σ and a_raw in fp32 as `composite_ref` computes them and
    exactly (float64) from the fp32 dx, dy, as an FMA-contracting kernel
    may come closer to: on the tiny scenes of `tests/test_torch_raster.py`
    and on the adversarial tables of `tests/raster_cases.py` (ellipses
    tangent to a sub-tile edge at a pixel centre, opacities just above
    1/255, needle conics with det → 0⁺, non-PD and degenerate conics, radii
    larger than the image);
  * `composite_ref` and `composite_bwd_ref` restricted to the kept
    (sub-tile, pair)s (`keep=`) give the unrestricted outputs bit for bit;
  * the mask is not vacuous: on small splats it drops at least
    MIN_DROPPED_SHARE of the (warp, pair)s, and an ellipse tangent to a
    sub-tile edge from outside keeps no bit beyond it;
  * the pairs it must not cull (non-PD, o < 1/255, non-finite, huge) get
    all 8 bits.
"""

import numpy as np
import pytest
import torch

from raster_cases import (Case, cull_share, early_stop_case, grazing_case,
                          long_segment_case, passing, small_splats_case,
                          warp_bits)
from test_rasterizer import make_scene
from test_torch_raster import opaque_scene
from vist3a_tpu_torch.kernels import rasterizer as tr

# the share of (warp, pair)s the mask must drop: on the tiny scene's own
# pair stream (`make_scene`, each splat paired with the tiles its 3σ box
# reaches; measured 0.6553) and on 1-3 px splats each paired with every
# tile of a 64² image (measured 0.9384)
MIN_DROPPED_SHARE = {"scene": 0.6, "small_splats": 0.9}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _view_case(scene) -> Case:
    means, covars, harm, op, vm, K, W, H = scene[:8]
    T = lambda x: torch.from_numpy(np.array(x, np.float32))     # noqa: E731
    table, pairs = tr.view_pairs(T(means), T(covars), T(harm), T(op), T(vm),
                                 T(K), W, H, 4096)
    return Case(pairs.gid, pairs.bounds, table, -(-W // tr.TILE), W, H)


CASES = {
    "scene": lambda: _view_case(make_scene(np.random.default_rng(0))),
    "opaque": lambda: _view_case(opaque_scene(np.random.default_rng(1))),
    "grazing_exact_0": lambda: grazing_case(0),
    "grazing_exact_1": lambda: grazing_case(1, 48, 48),
    "grazing_inset": lambda: grazing_case(2, exact=False),
    "small_splats": lambda: small_splats_case(0),
    "early_stop": lambda: early_stop_case(0, n=300),
}


def _mask(case: Case) -> torch.Tensor:
    return tr.subtile_mask_ref(case.table, case.ntx, case.width, case.height,
                               case.gid, case.bounds)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mask_covers_every_passing_pair(name):
    case = CASES[name]()
    mask = _mask(case)
    assert mask.dtype == torch.int32 and mask.shape == case.gid.shape
    assert int(mask.min()) >= 0 and int(mask.max()) <= 255
    bits = warp_bits(mask)
    for exact in (False, True):
        hits = passing(case, exact_sigma=exact)
        assert bool(hits.any())
        missed = hits & ~bits
        assert not bool(missed.any()), (
            f"{int(missed.sum())} passing (pixel, pair)s culled "
            f"(exact σ: {exact})")


@pytest.mark.parametrize("name", sorted(CASES))
def test_restricted_composites_are_bitwise_equal(name):
    case = CASES[name]()
    keep = _mask(case)
    args = (case.gid, case.bounds, case.table, case.ntx, case.width,
            case.height)
    out, n_eval, n_comp, _ = tr.composite_ref(*args, return_work=True)
    assert int(n_comp.sum()) > 0
    torch.testing.assert_close(tr.composite_ref(*args, keep=keep), out,
                               rtol=0, atol=0)
    gout = torch.from_numpy(np.random.default_rng(3).standard_normal(
        out.shape).astype(np.float32))
    want = tr.composite_bwd_ref(*args[:3], out, gout, *args[3:])
    got = tr.composite_bwd_ref(*args[:3], out, gout, *args[3:], keep=keep)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0


def test_restriction_is_not_a_no_op():
    """`keep` does reach the plain composite: a mask without warp 0's bit
    leaves the other warps' pixels as they were and changes warp 0's."""
    case = small_splats_case(1, n=120)
    args = (case.gid, case.bounds, case.table, case.ntx, case.width,
            case.height)
    out = tr.composite_ref(*args)
    cut = tr.composite_ref(*args, keep=_mask(case) & ~1)
    diff = (out - cut).abs().amax(0)
    warp = tr.pixel_warp().view(tr.TILE, tr.TILE).repeat(4, 4)
    assert float(diff[warp != 0].max()) == 0
    assert float(diff[warp == 0].max()) > 0.01


@pytest.mark.parametrize("name", sorted(MIN_DROPPED_SHARE))
def test_mask_drops_a_share_of_small_splats(name):
    dropped = cull_share(_mask(CASES[name]()))
    assert dropped >= MIN_DROPPED_SHARE[name], dropped


def test_tangent_from_outside_keeps_no_bit_beyond_the_edge():
    """A circle whose region ends 0.1 px short of the first pixel column of
    sub-tile column 1 (x = 8.5) reaches sub-tile column 0 only; 0.1 px
    past that column, it reaches both."""
    o, s = 0.5, 0.25
    ext = np.sqrt(2 * np.log(255 * o) / s)
    for gap, want in ((0.1, 0b01010101), (-0.1, 0b11111111)):
        mx = 8.5 - ext - gap
        case = Case(torch.zeros(1, dtype=torch.int32),
                    torch.tensor([0, 1], dtype=torch.int32),
                    torch.tensor([[mx, 8.0, s, 0.0, s, o, 1, 1, 1, 2]],
                                 dtype=torch.float32), 1, 16, 16)
        assert int(_mask(case)[0]) == want, gap


@pytest.mark.parametrize("row", [
    [8.0, 8.0, 0.5, 0.9, 0.5, 0.5],           # b² > ac
    [8.0, 8.0, 1.0, 1.0, 1.0, 0.5],           # det = 0
    [8.0, 8.0, 1.0, 1.0 - 1e-7, 1.0, 0.5],    # det/ac ~ 1e-7: a needle
    [8.0, 8.0, -0.3, 0.0, 0.4, 0.5],          # a < 0
    [8.0, 8.0, 0.0, 0.0, 0.2, 0.5],           # a = 0
    [8.0, 8.0, 0.5, 0.0, 0.5, 1e-3],          # o < 1/255
    [8.0, 8.0, 1e-14, 0.0, 1e-14, 0.5],       # an extent beyond 1e6 px
    [float("nan"), 8.0, 0.5, 0.0, 0.5, 0.5],  # a non-finite mean
    [8.0, 8.0, 0.5, float("inf"), 0.5, 0.5],  # a non-finite conic
    [8.0, 8.0, 0.5, 0.0, 0.5, float("nan")],  # a non-finite opacity
])
def test_uncullable_pairs_get_all_bits(row):
    table = torch.tensor([row + [1.0, 1.0, 1.0, 2.0]], dtype=torch.float32)
    case = Case(torch.zeros(1, dtype=torch.int32),
                torch.tensor([0, 1], dtype=torch.int32), table, 1, 16, 16)
    assert int(_mask(case)[0]) == 255


def test_pixel_warp_is_the_kernels_map():
    """Warp w owns the 8×4 sub-tile at column (w % 2)·8, row (w // 2)·4;
    lane l its pixel (l % 8, l // 8): thread 32·w + l."""
    warp = tr.pixel_warp().view(tr.TILE, tr.TILE)
    for tid in range(tr.PIX):
        w, lane = divmod(tid, 32)
        x = (w % 2) * tr.SUB_W + lane % 8
        y = (w // 2) * tr.SUB_H + lane // 8
        assert int(warp[y, x]) == w
    assert [int((warp == w).sum()) for w in range(tr.N_WARPS)] == [32] * 8


def test_long_segment_case_walks_over_ten_stages():
    """The card tests' long segment: every tile walks over ten 256-pair
    stages and no pixel stops."""
    case = long_segment_case(0)
    counts = case.bounds[1:] - case.bounds[:-1]
    assert int(counts.min()) > 10 * tr.PIX
    img = tr.composite_ref(case.gid, case.bounds, case.table, case.ntx, 32,
                           32)
    assert float(img[5].min()) >= tr.T_EPS


def test_early_stop_case_stops_every_pixel_in_the_first_stage():
    case = early_stop_case(0, n=300)
    _, n_eval, _, _ = tr.composite_ref(case.gid, case.bounds, case.table,
                                       case.ntx, 32, 32, return_work=True)
    assert int(n_eval.max()) <= 2


@pytest.mark.parametrize("name", ["early_stop", "grazing_exact_1", "scene"])
def test_warp_work_is_each_warps_walk(name):
    """`composite_ref(warp_work=True)`'s (warp, pair) figures, which
    `chip_smoke.py` reads the cull's statistics from: warp w walks the
    pairs of its tile up to its furthest pixel's stop (`n_eval`), and
    composites pair j exactly where the plain backward, given a random
    cotangent on warp w's pixels only, gives pair j colour or depth
    gradients; no composited (warp, pair) is culled."""
    case = CASES[name]()
    args = (case.gid, case.bounds, case.table, case.ntx, case.width,
            case.height)
    out, n_eval, _, _, walked, comp = tr.composite_ref(
        *args, return_work=True, warp_work=True)
    assert walked.shape == comp.shape == (tr.N_WARPS, case.gid.numel())
    assert bool(comp.any()) and not bool((comp & ~walked).any())
    kept = ((_mask(case)[None] >> torch.arange(tr.N_WARPS)[:, None]) & 1)
    assert not bool((comp & ~kept.bool()).any())
    nty = case.bounds.numel() // case.ntx
    warp = tr.pixel_warp().view(tr.TILE, tr.TILE).repeat(nty, case.ntx)[
        :case.height, :case.width]
    y, x = torch.meshgrid(torch.arange(case.height),
                          torch.arange(case.width), indexing="ij")
    tile = (y // tr.TILE) * case.ntx + x // tr.TILE
    want = torch.zeros_like(walked)
    starts = case.bounds.tolist()
    for t in range(len(starts) - 1):
        for w in range(tr.N_WARPS):
            reach = n_eval[(tile == t) & (warp == w)]
            if reach.numel():
                want[w, starts[t]:starts[t] + int(reach.max())] = True
    assert torch.equal(walked, want)
    gout = torch.from_numpy(np.random.default_rng(4).standard_normal(
        out.shape).astype(np.float32))
    for w in range(tr.N_WARPS):
        d = tr.composite_bwd_ref(*args[:3], out, gout * (warp == w),
                                 *args[3:])
        assert torch.equal(comp[w], (d[:, 6:10] != 0).any(1)), w
