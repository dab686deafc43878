"""The plain reference's 3D Gaussian-splat rasterizer (frozen from the
port's `kernels/rasterizer.py`, the composite on plain math; see
`reference/scene.py`; it imports nothing of the port).

The deployed gsplat "classic" call: RGB+D, explicit covariances, 0.3-px
dilation, near 1e-10, radius clip 0.1, background colour, alpha output.

  1. `project_gaussians` and `eval_sh` (degrees 0-4), fp32 throughout; the
     camera-space covariance is summed elementwise, so no TF32 product
     enters it.
  2. `build_pairs`: the (Gaussian, tile) pair stream: Gaussians sorted by
     depth (invalid ones at +inf), pairs expanded in depth-rank-major order
     over each Gaussian's tile bbox, the stream cut at the pair budget (the
     deepest Gaussians' pairs go first), then sorted by the int64 key
     tile·G + depth rank, with per-tile segment bounds.
  3. `composite_ref`: the alpha composite over each 16×16 tile's segment.

Composite rules: pixel centres at +0.5; σ = ½(a·dx² + c·dy²) + b·dx·dy and
a_raw = o·e^(−σ); a pair is skipped when σ < 0 or a_raw < 1/255, before the
clamp α = min(0.999, a_raw); a pixel stops for good at the first pair with
T·(1−α) < 1e-4, which is not composited.  Outputs per pixel: RGB Σw·c,
depth Σw·z, alpha Σw and T_final (w = α·T).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


TILE = 16
PIX = TILE * TILE
CHUNK = 128          # the JAX package rounds the pair budget up to this
ALPHA_CLAMP = 0.999
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
N_OUT = 6            # r, g, b | depth | alpha | T_final
# the deployed gsplat call: 0.3-px dilation, near 1e-10, far 1e10, radius
# clip 0.1 px
EPS2D = 0.3
NEAR_PLANE = 1e-10
FAR_PLANE = 1e10
RADIUS_CLIP = 0.1
REF_CHUNK = 4096     # pairs per step of the plain composite


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


def composite_ref(gid: torch.Tensor, bounds: torch.Tensor,
                  table: torch.Tensor, ntx: int, width: int,
                  height: int) -> torch.Tensor:
    """The composite → (6, H, W) fp32: tile by tile, over chunks of
    `REF_CHUNK` pairs with T carried between them; the transmittance is a
    running product in pair order."""
    device = table.device
    n_tiles = bounds.numel() - 1
    nty = n_tiles // ntx
    hp, wp = nty * TILE, ntx * TILE
    out = torch.zeros(N_OUT, nty, ntx, PIX, device=device)
    out[5] = 1.0
    p = torch.arange(PIX, device=device)
    lx = (p % TILE).float() + 0.5
    ly = torch.div(p, TILE, rounding_mode="floor").float() + 0.5
    starts = bounds.tolist()
    for t in range(n_tiles):
        s, e = starts[t], starts[t + 1]
        if s == e:
            continue
        ty, tx = divmod(t, ntx)
        px, py = (tx * TILE + lx)[:, None], (ty * TILE + ly)[:, None]
        trans = torch.ones(PIX, 1, device=device)
        acc = torch.zeros(PIX, 5, device=device)
        done = torch.zeros(PIX, 1, dtype=torch.bool, device=device)
        for c0 in range(s, e, REF_CHUNK):
            a = table[gid[c0:min(c0 + REF_CHUNK, e)].long()]      # (K, 10)
            dx, dy = px - a[:, 0], py - a[:, 1]
            sigma = 0.5 * (a[:, 2] * dx * dx + a[:, 4] * dy * dy) \
                + a[:, 3] * dx * dy
            a_raw = a[:, 5] * torch.exp(-sigma)
            ok = (sigma >= 0) & (a_raw >= ALPHA_MIN)
            alpha = torch.where(ok, torch.clamp_max(a_raw, ALPHA_CLAMP), 0.0)
            t_incl = torch.cumprod(torch.cat([trans, 1.0 - alpha], 1), 1)
            t_excl, t_incl = t_incl[:, :-1], t_incl[:, 1:]
            # t_incl never grows along the pairs, so `live` is a prefix
            live = (t_incl >= T_EPS) & ~done
            w = torch.where(live, alpha * t_excl, 0.0)
            payload = torch.cat([a[:, 6:10], torch.ones_like(a[:, :1])], 1)
            acc += (w[:, :, None] * payload[None]).sum(1)
            n_live = live.sum(1, keepdim=True)
            last = torch.gather(t_incl, 1, (n_live - 1).clamp_min(0))
            stops = (n_live < t_incl.shape[1]) & ~done
            trans = torch.where(n_live > 0, last, trans)
            done = done | stops
            if bool(done.all()):
                break
        out[:5, ty, tx] = acc.T
        out[5, ty, tx] = trans[:, 0]
    img = out.reshape(-1, nty, ntx, TILE, TILE).transpose(2, 3)
    return img.reshape(-1, hp, wp)[:, :height, :width].contiguous()


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
    proj = project_gaussians(means, covars, viewmat, K, width, height)
    R, t = viewmat[:3, :3].float(), viewmat[:3, 3].float()
    campos = -(R * t[:, None]).sum(0)                   # −Rᵀ t
    sh_degree = math.isqrt(harmonics.shape[-1]) - 1
    colors = eval_sh(harmonics, means.float() - campos, sh_degree)
    table = attribute_table(proj, colors, opacities)
    pairs = build_pairs(proj, ntx, nty, pair_budget,
                        extra_valid=table[:, 5] >= ALPHA_MIN)
    return table, pairs


def default_pair_budget(n_gaussians: int) -> int:
    """max(4·G, 1024) rounded up to a multiple of 128: the budget drops the
    deepest pairs first, the mostly occluded far tail."""
    return _cdiv(max(4 * n_gaussians, 1024), CHUNK) * CHUNK


def _render_view(means, covars, harmonics, opacities, viewmat, K,
                 width: int, height: int, budget: int, bg: torch.Tensor):
    """One view → (rgb (3, H, W), depth (H, W), alpha (H, W))."""
    table, pairs = view_pairs(means, covars, harmonics, opacities, viewmat,
                              K, width, height, budget)
    img = composite_ref(pairs.gid, pairs.bounds, table, _cdiv(width, TILE),
                        width, height)
    return img[:3] + img[5] * bg[:, None, None], img[3], img[4]


def rasterize(means, covars, harmonics, opacities, viewmats, Ks,
              width: int, height: int, *,
              background: torch.Tensor | None = None,
              pair_budget: int | None = None):
    """Multi-view 3DGS rasterization.

    means (G, 3), covars (G, 3, 3), harmonics (G, 3, d_sh), opacities (G,),
    viewmats (V, 4, 4) world→camera, Ks (V, 3, 3) in pixels.  Returns
    (rgb (V, H, W, 3), depth (V, H, W), alpha (V, H, W)); rgb has the
    background composited through T_final and is not clamped.
    pair_budget: pairs kept per view (rounded up to a multiple of 128; the
    deepest are cut first); None takes `default_pair_budget`."""
    device = means.device
    bg = torch.zeros(3, device=device) if background is None \
        else torch.as_tensor(background, dtype=torch.float32, device=device)
    budget = default_pair_budget(means.shape[0]) if pair_budget is None \
        else _cdiv(pair_budget, CHUNK) * CHUNK
    views = [_render_view(means, covars, harmonics, opacities,
                          viewmats[v].float(), Ks[v].float(), width, height,
                          budget, bg)
             for v in range(viewmats.shape[0])]
    rgb, depth, alpha = (torch.stack(x) for x in zip(*views))
    return rgb.permute(0, 2, 3, 1), depth, alpha
