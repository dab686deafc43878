"""3D Gaussian-splat rasterizer: projection, SH, pairs, composite and its
backward.

Port of `vist3a_tpu/kernels/rasterizer.py` (the deployed gsplat "classic"
call: RGB+D, explicit covariances, 0.3-px dilation, near 1e-10, radius clip
0.1, background colour, alpha output), differentiable.

  1. `project_gaussians` and `eval_sh` (degrees 0-4): plain PyTorch, fp32
     throughout.  The camera-space covariance is summed elementwise, so no
     TF32 product can enter it (the JAX package asks for precision
     "highest" there).
  2. `build_pairs`: the (Gaussian, tile) pair stream with the JAX package's
     semantics, written with `torch.sort`, `torch.cumsum` and
     `torch.searchsorted`: Gaussians sorted by depth (invalid ones at +inf),
     pairs expanded in depth-rank-major order over each Gaussian's tile
     bbox, the stream cut at the pair budget (so the budget drops the
     DEEPEST Gaussians' pairs first), then sorted by the int64 key
     tile·G + depth rank, with per-tile segment bounds.  The TPU's visit
     list, bit-packing and triangular-matmul prefix sums are scheduling and
     are not ported.
  3. `composite`: the alpha composite over each 16×16 tile's segment —
     the Hopper kernel `csrc/rasterize_fwd.cu` on CUDA tensors, its plain
     version `composite_ref` on CPU tensors.  `launches` counts the kernel.
     Both kernels give each warp of a tile's block an 8×4 sub-tile and walk
     a warp only over the pairs whose a_raw ≥ 1/255 region can reach it
     (`csrc/raster_common.cuh`); `subtile_mask_ref` is that cull mask's
     plain version, and the plain composites restricted to it
     (`keep=...`) give the same outputs as unrestricted.
  4. `Composite`, the autograd function `rasterize` calls: its backward is
     `composite_bwd` — the Hopper kernel `csrc/rasterize_bwd.cu` on CUDA
     tensors (`launches_backward` counts it), the explicit plain version
     `composite_bwd_ref` on CPU tensors — giving each pair's gradient row,
     and `pair_rows_to_gaussians`, which sums the rows per Gaussian (the
     JAX `_gather_pair_rows_bwd`).  Autograd then carries the (G, 10)
     table's gradient through the projection and SH to the Gaussians.

Composite rules (kernel and plain version): pixel centres at +0.5;
σ = ½(a·dx² + c·dy²) + b·dx·dy and a_raw = o·e^(−σ); a pair is skipped when
σ < 0 or a_raw < 1/255, before the clamp α = min(0.999, a_raw); a pixel
stops for good at the first pair with T·(1−α) < 1e-4, which is not
composited.  Outputs per pixel: RGB Σw·c, depth Σw·z, alpha Σw and T_final
(w = α·T).  The backward reproduces the forward's stopping set and masks,
and gives α no gradient where a_raw ≥ 0.999 (the clamp).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from vist3a_tpu_torch.core.profiling import span
from vist3a_tpu_torch.kernels import build

SOURCE = "rasterize_fwd.cu"
BWD_SOURCE = "rasterize_bwd.cu"
TILE = 16
PIX = TILE * TILE
CHUNK = 128          # the JAX package rounds the pair budget up to this
ALPHA_CLAMP = 0.999
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
N_ATTR = 10          # mean x, y | conic a, b, c | opacity | r, g, b | depth
N_OUT = 6            # r, g, b | depth | alpha | T_final
# the deployed gsplat call: 0.3-px dilation, near 1e-10, far 1e10, radius
# clip 0.1 px
EPS2D = 0.3
NEAR_PLANE = 1e-10
FAR_PLANE = 1e10
RADIUS_CLIP = 0.1
REF_CHUNK = 4096     # pairs per step of the plain composite
# a warp's sub-tile in the kernels: 8 pixels wide, 4 high, warps numbered
# row-major over the tile's 2 × 4 sub-tiles
SUB_W, SUB_H = 8, 4
N_WARPS = PIX // 32
# the cull mask's margins (csrc/raster_common.cuh says why each suffices)
CULL_DIAG = 1e-4
CULL_DET = 1e-5
CULL_LEVEL = 1e-4
CULL_EXTENT = 1e-4
CULL_PAD = 1e-2
CULL_HUGE = 1e6

launches = 0
launches_backward = 0


def reset_launch_counts() -> None:
    global launches, launches_backward
    launches = 0
    launches_backward = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Projected(NamedTuple):
    mean2d: torch.Tensor   # (G, 2) pixel coordinates
    conic: torch.Tensor    # (G, 3) upper triangle (a, b, c) of Σ2d⁻¹
    depth: torch.Tensor    # (G,) camera-space z
    radius: torch.Tensor   # (G,) 3σ screen radius, px
    valid: torch.Tensor    # (G,) bool


class Pairs(NamedTuple):
    gid: torch.Tensor      # (P,) int32 Gaussian ids sorted by (tile, depth)
    bounds: torch.Tensor   # (n_tiles + 1,) int32 tile segment starts
    total: int             # pairs before the budget cut (P = min(total, budget))


def project_gaussians(means, covars, viewmat, K, width,
                      height) -> Projected:
    """Perspective projection (gsplat `fully_fused_projection`, classic)."""
    means, covars = means.float(), covars.float()
    R, t = viewmat[:3, :3].float(), viewmat[:3, 3].float()
    K = K.float()
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    p_cam = (means[:, None, :] * R).sum(-1) + t               # (G, 3)
    tz = p_cam[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    rz = 1.0 / tz_safe

    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    txz = torch.clamp(p_cam[:, 0] * rz, -lim_x, lim_x)
    tyz = torch.clamp(p_cam[:, 1] * rz, -lim_y, lim_y)

    # R Σ Rᵀ summed elementwise in fp32
    rs = (R[None, :, :, None] * covars[:, None, :, :]).sum(2)  # (G, 3, 3)
    cov_cam = (rs[:, :, None, :] * R[None, None, :, :]).sum(-1)
    j00 = fx * rz
    j11 = fy * rz
    j02 = -fx * txz * rz
    j12 = -fy * tyz * rz
    c00, c01, c02 = cov_cam[:, 0, 0], cov_cam[:, 0, 1], cov_cam[:, 0, 2]
    c11, c12, c22 = cov_cam[:, 1, 1], cov_cam[:, 1, 2], cov_cam[:, 2, 2]
    sxx = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    syy = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)
    sxy = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    sxx = sxx + EPS2D
    syy = syy + EPS2D

    det = sxx * syy - sxy * sxy
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([syy / det_safe, -sxy / det_safe, sxx / det_safe], -1)
    mean2d = torch.stack([fx * p_cam[:, 0] * rz + cx,
                          fy * p_cam[:, 1] * rz + cy], -1)

    mid = 0.5 * (sxx + syy)
    v1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))

    inside = ((mean2d[:, 0] + radius > 0) & (mean2d[:, 0] - radius < width)
              & (mean2d[:, 1] + radius > 0) & (mean2d[:, 1] - radius < height))
    valid = ((tz > NEAR_PLANE) & (tz < FAR_PLANE) & (det > 0)
             & (radius > RADIUS_CLIP) & inside)
    return Projected(mean2d, conic, tz, radius, valid)


# gsplat sh.cuh real SH basis constants, degrees 0..4.
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)
_SH_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
          -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
          0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def _sh_basis(d: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """Unit directions (..., 3) → the (..., (deg+1)²) real SH basis."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = [torch.full_like(x, _SH_C0)]
    if sh_degree >= 1:
        basis += [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x]
    if sh_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [_SH_C2[0] * xy, _SH_C2[1] * yz,
                  _SH_C2[2] * (2 * zz - xx - yy), _SH_C2[3] * xz,
                  _SH_C2[4] * (xx - yy)]
    if sh_degree >= 3:
        basis += [_SH_C3[0] * y * (3 * xx - yy), _SH_C3[1] * xy * z,
                  _SH_C3[2] * y * (4 * zz - xx - yy),
                  _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  _SH_C3[4] * x * (4 * zz - xx - yy),
                  _SH_C3[5] * z * (xx - yy), _SH_C3[6] * x * (xx - 3 * yy)]
    if sh_degree >= 4:
        basis += [_SH_C4[0] * xy * (xx - yy), _SH_C4[1] * yz * (3 * xx - yy),
                  _SH_C4[2] * xy * (7 * zz - 1), _SH_C4[3] * yz * (7 * zz - 3),
                  _SH_C4[4] * (zz * (35 * zz - 30) + 3),
                  _SH_C4[5] * xz * (7 * zz - 3),
                  _SH_C4[6] * (xx - yy) * (7 * zz - 1),
                  _SH_C4[7] * xz * (xx - 3 * yy),
                  _SH_C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(basis, -1)


def eval_sh(harmonics: torch.Tensor, dirs: torch.Tensor,
            sh_degree: int) -> torch.Tensor:
    """harmonics (..., 3, d_sh), dirs (..., 3) → RGB (+0.5, clamped ≥ 0)."""
    dirs = dirs.float()
    d = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
    basis = _sh_basis(d, sh_degree)                       # (..., n)
    n = basis.shape[-1]
    c = (harmonics[..., :n].float() * basis[..., None, :]).sum(-1)
    return torch.clamp_min(c + 0.5, 0.0)


def build_pairs(proj: Projected, ntx: int, nty: int, pair_budget: int,
                extra_valid: torch.Tensor | None = None) -> Pairs:
    """(Gaussian, tile) pairs sorted by (tile, depth), cut at the budget."""
    device = proj.depth.device
    g = proj.depth.shape[0]
    n_tiles = ntx * nty
    valid = proj.valid if extra_valid is None else proj.valid & extra_valid

    mx, my, r = proj.mean2d[:, 0], proj.mean2d[:, 1], proj.radius
    x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, ntx).long()
    x1 = torch.clamp(torch.ceil((mx + r) / TILE), 0, ntx).long()
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, nty).long()
    y1 = torch.clamp(torch.ceil((my + r) / TILE), 0, nty).long()
    zero = torch.zeros_like(x0)
    w = torch.where(valid, x1 - x0, zero)
    n_per_g = w * torch.where(valid, y1 - y0, zero)

    # depth rank: a stable sort, invalid Gaussians last (they emit nothing)
    key = torch.where(valid, proj.depth.float(),
                      torch.full_like(proj.depth, float("inf"), dtype=torch.float32))
    order = torch.sort(key, stable=True).indices
    ends = torch.cumsum(n_per_g[order], 0)                # inclusive, by rank
    total = int(ends[-1]) if g else 0
    n_pairs = min(total, pair_budget)

    # slot → depth rank → (tile, rank) key; the budget keeps the nearest
    slot = torch.arange(n_pairs, device=device)
    rank = torch.searchsorted(ends, slot, right=True)
    gi = order[rank]
    local = slot - (ends[rank] - n_per_g[gi])
    wg = w[gi]
    dy = torch.div(local, wg, rounding_mode="floor")
    tile = (y0[gi] + dy) * ntx + x0[gi] + (local - dy * wg)
    key_s = torch.sort(tile * g + rank).values
    gid = order[key_s % g].int()
    bounds = torch.searchsorted(
        key_s, torch.arange(n_tiles + 1, device=device) * g).int()
    return Pairs(gid, bounds, total)


def subtile_mask_ref(table: torch.Tensor, ntx: int, width: int, height: int,
                     gid: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(P,) int32: each pair's cull mask, bit w set when the pair's
    a_raw ≥ 1/255 region can reach a pixel centre of warp w's 8×4 sub-tile
    of the pair's tile (w = 2·(y // 4) + x // 8 within the tile).

    Mirrors `csrc/raster_common.cuh::subtile_mask` operation by operation
    in fp32, margins included (the header states why each suffices): the
    ellipse σ ≤ ln(255·o) of the conic with its diagonal shrunk by
    `CULL_DIAG`, det lowered by `CULL_DET`, the level raised by
    `CULL_LEVEL`, the half-extents widened by `CULL_EXTENT` and `CULL_PAD`.
    A non-PD conic, o < 1/255, a non-finite value or an extent beyond
    `CULL_HUGE` gives all 8 bits."""
    _tile_grid(bounds, ntx, width, height)
    device = table.device
    idx = torch.arange(gid.numel(), device=device)
    tile = torch.searchsorted(bounds[1:].long(), idx, right=True)
    ty = torch.div(tile, ntx, rounding_mode="floor")
    x0 = ((tile - ty * ntx) * TILE).float() + 0.5
    y0 = (ty * TILE).float() + 0.5
    mx, my, a, b, c, o = table[gid.long()].float()[:, :6].unbind(1)
    ap = a * (1.0 - CULL_DIAG)
    cp = c * (1.0 - CULL_DIAG)
    det = ap * cp - b * b
    det_lo = det - CULL_DET * (ap * cp + b * b)
    level = torch.log(255.0 * o)
    lv = level + CULL_LEVEL * (level.abs() + 1.0)
    ex = torch.sqrt(2.0 * lv * cp / det_lo) * (1.0 + CULL_EXTENT) + CULL_PAD
    ey = torch.sqrt(2.0 * lv * ap / det_lo) * (1.0 + CULL_EXTENT) + CULL_PAD
    culls = ((ap > 0) & (cp > 0) & (det_lo > 0) & (o >= ALPHA_MIN)
             & (ex <= CULL_HUGE) & (ey <= CULL_HUGE)
             & (mx.abs() <= CULL_HUGE) & (my.abs() <= CULL_HUGE))
    mask = torch.zeros(gid.numel(), dtype=torch.int32, device=device)
    for w in range(N_WARPS):
        sx0 = x0 + float((w % 2) * SUB_W)
        sy0 = y0 + float((w // 2) * SUB_H)
        sx1 = sx0 + float(SUB_W - 1)
        sy1 = sy0 + float(SUB_H - 1)
        hit = ((sx0 - mx <= ex) & (mx - sx1 <= ex)
               & (sy0 - my <= ey) & (my - sy1 <= ey))
        mask |= hit.int() << w
    return torch.where(culls, mask, (1 << N_WARPS) - 1)


def pixel_warp() -> torch.Tensor:
    """(PIX,) the warp whose sub-tile holds each pixel of a tile, pixels
    row-major (p = 16·y + x)."""
    p = torch.arange(PIX)
    return (p // TILE // SUB_H) * (TILE // SUB_W) + (p % TILE) // SUB_W


def _kept(keep, c0: int, c1: int, warp_of) -> torch.Tensor | bool:
    """(PIX, K) whether each pixel's warp walks each pair of the chunk."""
    if keep is None:
        return True
    return ((keep[c0:c1][None, :] >> warp_of[:, None]) & 1).bool()


def composite_ref(gid: torch.Tensor, bounds: torch.Tensor,
                  table: torch.Tensor, ntx: int, width: int, height: int, *,
                  return_work: bool = False, warp_work: bool = False,
                  keep: torch.Tensor | None = None):
    """Plain PyTorch version of the composite kernel → (6, H, W) fp32.

    Tile by tile, over chunks of `REF_CHUNK` pairs with T carried between
    them; the transmittance is a running product in pair order (a
    sequential `cumprod` on the CPU, as the kernel multiplies).  With
    `return_work`, also returns per-pixel counts (pairs evaluated up to and
    including the stopping pair, pairs composited, and of those the pairs
    whose α was clamped at `ALPHA_CLAMP`), each (H, W) int64; with
    `warp_work` as well, then two (N_WARPS, P) bool: whether some pixel of
    each warp's sub-tile (within the image) evaluates each pair up to and
    including its stop, and whether one composites it.  `keep`, a
    (P,) mask as `subtile_mask_ref` gives, restricts each pixel to the
    pairs its warp walks (a culled pair counts as skipped)."""
    device = table.device
    n_tiles = bounds.numel() - 1
    nty = n_tiles // ntx
    hp, wp = nty * TILE, ntx * TILE
    out = torch.zeros(N_OUT, nty, ntx, PIX, device=device)
    out[5] = 1.0
    n_eval = torch.zeros(nty, ntx, PIX, dtype=torch.long, device=device)
    n_comp = torch.zeros_like(n_eval)
    n_clamp = torch.zeros_like(n_eval)
    p = torch.arange(PIX, device=device)
    lx = (p % TILE).float() + 0.5
    ly = torch.div(p, TILE, rounding_mode="floor").float() + 0.5
    warp_of = pixel_warp().to(device)
    by_warp = torch.argsort(warp_of, stable=True)   # warp w: rows 32w ..
    if warp_work:
        walked = torch.zeros(N_WARPS, gid.numel(), dtype=torch.bool,
                             device=device)
        composited = torch.zeros_like(walked)
    starts = bounds.tolist()
    for t in range(n_tiles):
        s, e = starts[t], starts[t + 1]
        if s == e:
            continue
        ty, tx = divmod(t, ntx)
        px, py = (tx * TILE + lx)[:, None], (ty * TILE + ly)[:, None]
        inside = (px < width) & (py < height)
        trans = torch.ones(PIX, 1, device=device)
        acc = torch.zeros(PIX, 5, device=device)
        done = torch.zeros(PIX, 1, dtype=torch.bool, device=device)
        for c0 in range(s, e, REF_CHUNK):
            a = table[gid[c0:min(c0 + REF_CHUNK, e)].long()]      # (K, 10)
            dx, dy = px - a[:, 0], py - a[:, 1]
            sigma = 0.5 * (a[:, 2] * dx * dx + a[:, 4] * dy * dy) \
                + a[:, 3] * dx * dy
            a_raw = a[:, 5] * torch.exp(-sigma)
            ok = (sigma >= 0) & (a_raw >= ALPHA_MIN) \
                & _kept(keep, c0, c0 + a.shape[0], warp_of)
            alpha = torch.where(ok, torch.clamp_max(a_raw, ALPHA_CLAMP), 0.0)
            t_incl = torch.cumprod(torch.cat([trans, 1.0 - alpha], 1), 1)
            t_excl, t_incl = t_incl[:, :-1], t_incl[:, 1:]
            # t_incl never grows along the pairs, so `live` is a prefix
            live = (t_incl >= T_EPS) & ~done
            if warp_work:
                c1 = c0 + a.shape[0]
                for dst, x in ((walked, (t_excl >= T_EPS) & ~done),
                               (composited, live & ok)):
                    dst[:, c0:c1] = (x & inside)[by_warp].view(
                        N_WARPS, 32, -1).any(1)
            w = torch.where(live, alpha * t_excl, 0.0)
            payload = torch.cat([a[:, 6:10], torch.ones_like(a[:, :1])], 1)
            acc += (w[:, :, None] * payload[None]).sum(1)
            n_live = live.sum(1, keepdim=True)
            last = torch.gather(t_incl, 1, (n_live - 1).clamp_min(0))
            stops = (n_live < t_incl.shape[1]) & ~done
            n_eval[ty, tx] += (n_live + stops.long()).squeeze(1)
            n_comp[ty, tx] += (live & ok).sum(1)
            n_clamp[ty, tx] += (live & ok & (a_raw >= ALPHA_CLAMP)).sum(1)
            trans = torch.where(n_live > 0, last, trans)
            done = done | stops
            if bool(done.all()):
                break
        out[:5, ty, tx] = acc.T
        out[5, ty, tx] = trans[:, 0]

    def image(x):
        x = x.reshape(-1, nty, ntx, TILE, TILE).transpose(2, 3)
        return x.reshape(-1, hp, wp)[:, :height, :width].contiguous()

    img = image(out)
    if not return_work:
        return img
    work = (image(n_eval)[0], image(n_comp)[0], image(n_clamp)[0])
    return (img, *work, walked, composited) if warp_work else (img, *work)


def composite_bwd_ref(gid: torch.Tensor, bounds: torch.Tensor,
                      table: torch.Tensor, out: torch.Tensor,
                      gout: torch.Tensor, ntx: int, width: int,
                      height: int, *,
                      keep: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the composite backward kernel: the gradient
    (P, 10) of every pair's table row, given the forward's output `out` and
    its cotangent `gout` (each (6, H, W)), computed explicitly, without
    autograd.

    Tile by tile over chunks of `REF_CHUNK` pairs, as `composite_ref`, with
    T, the stop flag and the prefix Σ w·gp carried between chunks; the
    suffix that dα needs is the total Σ_c g_c·out_c less the prefix, plus
    the T_final cotangent g_T·T_N (the TPU kernel's form).  `keep`
    restricts each pixel to its warp's pairs, as in `composite_ref`."""
    device = table.device
    n_tiles = bounds.numel() - 1
    nty = n_tiles // ntx
    hp, wp = nty * TILE, ntx * TILE

    def tiles(img):            # (C, H, W) → (n_tiles, PIX, C), zero padded
        x = torch.zeros(img.shape[0], hp, wp, device=device)
        x[:, :height, :width] = img
        x = x.reshape(-1, nty, TILE, ntx, TILE).permute(1, 3, 2, 4, 0)
        return x.reshape(n_tiles, PIX, -1)

    g_t, o_t = tiles(gout.float()), tiles(out.float())
    dpair = torch.zeros(gid.numel(), N_ATTR, device=device)
    p = torch.arange(PIX, device=device)
    lx = (p % TILE).float() + 0.5
    ly = torch.div(p, TILE, rounding_mode="floor").float() + 0.5
    warp_of = pixel_warp().to(device)
    starts = bounds.tolist()
    for t in range(n_tiles):
        s, e = starts[t], starts[t + 1]
        if s == e:
            continue
        ty, tx = divmod(t, ntx)
        px, py = (tx * TILE + lx)[:, None], (ty * TILE + ly)[:, None]
        inside = ((px < width) & (py < height))                  # (PIX, 1)
        g = g_t[t]                                               # (PIX, 6)
        o_total = (g[:, :5] * o_t[t, :, :5]).sum(1, keepdim=True)
        g_tn = g[:, 5:6] * o_t[t, :, 5:6]
        trans = torch.ones(PIX, 1, device=device)
        prefix = torch.zeros(PIX, 1, device=device)
        done = ~inside
        for c0 in range(s, e, REF_CHUNK):
            c1 = min(c0 + REF_CHUNK, e)
            a = table[gid[c0:c1].long()].float()                 # (K, 10)
            dx, dy = px - a[:, 0], py - a[:, 1]
            sigma = 0.5 * (a[:, 2] * dx * dx + a[:, 4] * dy * dy) \
                + a[:, 3] * dx * dy
            a_raw = a[:, 5] * torch.exp(-sigma)
            ok = (sigma >= 0) & (a_raw >= ALPHA_MIN) \
                & _kept(keep, c0, c1, warp_of)
            alpha = torch.where(ok, torch.clamp_max(a_raw, ALPHA_CLAMP), 0.0)
            t_incl = torch.cumprod(torch.cat([trans, 1.0 - alpha], 1), 1)
            t_excl, t_incl = t_incl[:, :-1], t_incl[:, 1:]
            live = (t_incl >= T_EPS) & ~done
            w = torch.where(live, alpha * t_excl, 0.0)
            gp = g[:, :4] @ a[:, 6:10].T + g[:, 4:5]             # (PIX, K)
            q_incl = torch.cumsum(w * gp, 1) + prefix
            mask = live & ok & (a_raw < ALPHA_CLAMP)
            dalpha = torch.where(
                mask, gp * t_excl - (o_total - q_incl + g_tn) / (1.0 - alpha),
                0.0)
            dsig = -alpha * dalpha
            inv_o = 1.0 / torch.clamp_min(a[:, 5], 1e-12)
            d = torch.stack([
                -(dsig * (a[:, 2] * dx + a[:, 3] * dy)).sum(0),
                -(dsig * (a[:, 4] * dy + a[:, 3] * dx)).sum(0),
                0.5 * (dsig * dx * dx).sum(0),
                (dsig * dx * dy).sum(0),
                0.5 * (dsig * dy * dy).sum(0),
                (alpha * inv_o * dalpha).sum(0)], 1)             # (K, 6)
            dpair[c0:c1] = torch.cat([d, w.T @ g[:, :4]], 1)
            n_live = live.sum(1, keepdim=True)
            last = torch.gather(t_incl, 1, (n_live - 1).clamp_min(0))
            stops = (n_live < t_incl.shape[1]) & ~done
            trans = torch.where(n_live > 0, last, trans)
            prefix = q_incl[:, -1:]
            done = done | stops
            if bool(done.all()):
                break
    return dpair


def pair_rows_to_gaussians(dpair: torch.Tensor, gid: torch.Tensor,
                           n_gauss: int) -> torch.Tensor:
    """(P, 10) per-pair gradient rows → (G, 10) per-Gaussian sums, the JAX
    `_gather_pair_rows_bwd` (`rasterizer.py:784-797`): the rows sorted by
    Gaussian id (a stable sort) and summed per Gaussian's segment
    (`torch.segment_reduce` over the integer bincount's lengths).  Each
    segment is summed in pair order by one thread, so the result is the
    same bits on every run (no atomics, no floating-point scan), and exact
    up to fp32 rounding, where the JAX package's prefix-sum difference
    loses up to 1.8e-4 to cancellation."""
    order = torch.sort(gid, stable=True).indices
    counts = torch.bincount(gid.long(), minlength=n_gauss)
    return torch.segment_reduce(dpair[order], "sum", lengths=counts,
                                axis=0, unsafe=True)


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.rasterize_composite_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return lib



def _check(gid, bounds, table, ntx, width, height) -> None:
    for name, x, dtype in (("gid", gid, torch.int32),
                           ("bounds", bounds, torch.int32),
                           ("table", table, torch.float32)):
        if x.device != table.device:
            raise ValueError(f"{name} on {x.device}, table on {table.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gid.dim() != 1 or table.dim() != 2 or table.shape[1] != N_ATTR:
        raise ValueError(f"gid (P,) and table (G, {N_ATTR}), got "
                         f"{tuple(gid.shape)} and {tuple(table.shape)}")
    _tile_grid(bounds, ntx, width, height)
    if table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned: the kernels copy "
                         "its rows 8 bytes at a time")


def _tile_grid(bounds, ntx: int, width: int, height: int) -> None:
    n_tiles = bounds.numel() - 1
    if n_tiles <= 0 or n_tiles % ntx or ntx != _cdiv(width, TILE) \
            or n_tiles // ntx != _cdiv(height, TILE):
        raise ValueError(f"{n_tiles} tile bounds for a {width}×{height} "
                         f"image with {ntx} tile columns")


def composite(gid: torch.Tensor, bounds: torch.Tensor, table: torch.Tensor,
              ntx: int, width: int, height: int) -> torch.Tensor:
    """(6, H, W) fp32 planes r, g, b, depth, alpha, T_final — the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    global launches
    if table.device.type == "cpu":
        return composite_ref(gid, bounds, table, ntx, width, height)
    if table.device.type != "cuda":
        raise ValueError(f"no composite kernel for {table.device}")
    _check(gid, bounds, table, ntx, width, height)
    out = torch.empty(N_OUT, height, width, dtype=torch.float32,
                      device=table.device)
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rasterize_composite_fwd(
            gid.data_ptr(), bounds.data_ptr(), table.data_ptr(),
            out.data_ptr(), bounds.numel() - 1, ntx, width, height, stream)
    if err:
        raise RuntimeError(f"rasterize_composite_fwd launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    fn = lib.rasterize_composite_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return lib


def composite_bwd(gid: torch.Tensor, bounds: torch.Tensor,
                  table: torch.Tensor, out: torch.Tensor, gout: torch.Tensor,
                  ntx: int, width: int, height: int) -> torch.Tensor:
    """(P, 10) per-pair gradient rows — the backward kernel on CUDA
    tensors, the plain version on CPU tensors."""
    global launches_backward
    if table.device.type == "cpu":
        return composite_bwd_ref(gid, bounds, table, out, gout, ntx, width,
                                 height)
    if table.device.type != "cuda":
        raise ValueError(f"no composite kernel for {table.device}")
    _check(gid, bounds, table, ntx, width, height)
    planes = (N_OUT, height, width)
    for name, x in (("out", out), ("gout", gout)):
        if x.device != table.device or x.dtype != torch.float32 \
                or tuple(x.shape) != planes:
            raise ValueError(f"{name} must be fp32 {planes} on "
                             f"{table.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    out, gout = out.contiguous(), gout.contiguous()
    dpair = torch.zeros(gid.numel(), N_ATTR, dtype=torch.float32,
                        device=table.device)
    lib = _bwd_lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rasterize_composite_bwd(
            gid.data_ptr(), bounds.data_ptr(), table.data_ptr(),
            out.data_ptr(), gout.data_ptr(), dpair.data_ptr(),
            bounds.numel() - 1, ntx, width, height, stream)
    if err:
        raise RuntimeError(f"rasterize_composite_bwd launch failed: "
                           f"cudaError {err}")
    launches_backward += 1
    return dpair


class Composite(torch.autograd.Function):
    """The composite of a (G, 10) table over a pair stream, differentiable
    in the table: the forward saves its output for `composite_bwd`."""

    @staticmethod
    def forward(ctx, table, gid, bounds, ntx, width, height):
        out = composite(gid, bounds, table, ntx, width, height)
        ctx.save_for_backward(table, gid, bounds, out)
        ctx.dims = (ntx, width, height)
        return out

    @staticmethod
    def backward(ctx, gout):
        table, gid, bounds, out = ctx.saved_tensors
        dpair = composite_bwd(gid, bounds, table, out, gout, *ctx.dims)
        return (pair_rows_to_gaussians(dpair, gid, table.shape[0]),
                None, None, None, None, None)


def attribute_table(proj: Projected, colors: torch.Tensor,
                    opacities: torch.Tensor) -> torch.Tensor:
    """(G, 10) per-Gaussian rows the composite gathers: mean, conic,
    opacity (zero where the projection is invalid), rgb, depth."""
    op = torch.where(proj.valid, opacities.float(), 0.0)
    return torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1],
                        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
                        op, colors[:, 0], colors[:, 1], colors[:, 2],
                        proj.depth], 1).contiguous()


def view_pairs(means, covars, harmonics, opacities, viewmat, K, width,
               height, pair_budget) -> tuple[torch.Tensor, Pairs]:
    """One view up to the composite: (attribute table, pair stream), with
    SH of the degree that harmonics (G, 3, (deg+1)²) holds.  The opacity
    cull (op ≥ 1/255 on the valid-masked opacities) happens here."""
    ntx, nty = _cdiv(width, TILE), _cdiv(height, TILE)
    with span("render.project_sh_table"):
        proj = project_gaussians(means, covars, viewmat, K, width, height)
        R, t = viewmat[:3, :3].float(), viewmat[:3, 3].float()
        campos = -(R * t[:, None]).sum(0)                   # −Rᵀ t
        sh_degree = math.isqrt(harmonics.shape[-1]) - 1
        colors = eval_sh(harmonics, means.float() - campos, sh_degree)
        table = attribute_table(proj, colors, opacities)
    with span("render.pairs"):
        pairs = build_pairs(proj, ntx, nty, pair_budget,
                            extra_valid=table[:, 5] >= ALPHA_MIN)
    return table, pairs


def default_pair_budget(n_gaussians: int) -> int:
    """max(4·G, 1024) rounded up to a multiple of 128: the budget drops the
    deepest pairs first, the mostly occluded far tail."""
    return _cdiv(max(4 * n_gaussians, 1024), CHUNK) * CHUNK


def _render_view(means, covars, harmonics, opacities, viewmat, K,
                 width: int, height: int, budget: int, bg: torch.Tensor):
    """One view → (rgb (3, H, W), depth (H, W), alpha (H, W)),
    differentiable through `Composite`."""
    table, pairs = view_pairs(means, covars, harmonics, opacities, viewmat,
                              K, width, height, budget)
    with span("render.composite"):
        img = Composite.apply(table, pairs.gid, pairs.bounds,
                              _cdiv(width, TILE), width, height)
    with span("render.background"):
        return img[:3] + img[5] * bg[:, None, None], img[3], img[4]


def rasterize(means, covars, harmonics, opacities, viewmats, Ks,
              width: int, height: int, *,
              background: torch.Tensor | None = None,
              pair_budget: int | None = None, remat_views: bool = False):
    """Multi-view 3DGS rasterization, one composite launch per view,
    differentiable in the Gaussians.

    means (G, 3), covars (G, 3, 3), harmonics (G, 3, d_sh), opacities (G,),
    viewmats (V, 4, 4) world→camera, Ks (V, 3, 3) in pixels.  Returns
    (rgb (V, H, W, 3), depth (V, H, W), alpha (V, H, W)); rgb has the
    background composited through T_final and is not clamped.  The stages
    of a view are spans (`core/profiling.span`) named `render.*`.

    pair_budget: pairs kept per view (rounded up to a multiple of 128; the
    deepest are cut first); None takes `default_pair_budget`.
    remat_views: each view recomputed in the backward (its pairs, table and
    composite: one more forward launch a view), so that one view's
    residuals live at a time, not all of them (the JAX package's per-view
    `jax.checkpoint`)."""
    device = means.device
    bg = torch.zeros(3, device=device) if background is None \
        else torch.as_tensor(background, dtype=torch.float32, device=device)
    budget = default_pair_budget(means.shape[0]) if pair_budget is None \
        else _cdiv(pair_budget, CHUNK) * CHUNK
    views = []
    for v in range(viewmats.shape[0]):
        args = (means, covars, harmonics, opacities, viewmats[v].float(),
                Ks[v].float(), width, height, budget, bg)
        if remat_views and torch.is_grad_enabled():
            views.append(checkpoint(_render_view, *args,
                                    use_reentrant=False))
        else:
            views.append(_render_view(*args))
    rgb, depth, alpha = (torch.stack(x) for x in zip(*views))
    return rgb.permute(0, 2, 3, 1), depth, alpha
