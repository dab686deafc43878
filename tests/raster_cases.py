"""Composite inputs that stress the composite kernels' cull mask and walk,
made with numpy from a seed.  Imports torch and the port only, so the card
tests (`tests/test_torch_gpu.py`) and `tools/torch_flash_mutants.py` use
them as the CPU tests do.

Each builder returns `Case(gid, bounds, table, ntx, width, height)`: a
(G, 10) table (mean x, y, conic a, b, c, opacity, r, g, b, depth) and the
pair stream that pairs every Gaussian with every tile, in table order (the
composite does not care whether the order is by depth).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vist3a_tpu_torch.kernels import rasterizer as tr


class Case(NamedTuple):
    gid: torch.Tensor
    bounds: torch.Tensor
    table: torch.Tensor
    ntx: int
    width: int
    height: int

    def to(self, device) -> "Case":
        return self._replace(gid=self.gid.to(device),
                             bounds=self.bounds.to(device),
                             table=self.table.to(device))


def all_pairs(rows: np.ndarray, width: int, height: int) -> Case:
    """Every Gaussian paired with every tile, in row order."""
    ntx, nty = -(-width // tr.TILE), -(-height // tr.TILE)
    g, n_tiles = rows.shape[0], ntx * nty
    gid = torch.arange(g, dtype=torch.int32).repeat(n_tiles)
    bounds = (torch.arange(n_tiles + 1) * g).int()
    table = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
    return Case(gid, bounds, table, ntx, width, height)


def _rows(mean, conic, opacity, rng) -> np.ndarray:
    n = len(opacity)
    rgb = rng.uniform(0.05, 1.0, (n, 3))
    depth = rng.uniform(1.0, 8.0, (n, 1))
    return np.concatenate([np.asarray(mean, np.float64).reshape(n, 2),
                           np.asarray(conic, np.float64).reshape(n, 3),
                           np.asarray(opacity, np.float64).reshape(n, 1),
                           rgb, depth], 1)


def _edges(extent: int, sub: int) -> np.ndarray:
    """Pixel centres on either side of every sub-tile boundary."""
    first = np.arange(0, extent, sub) + 0.5
    return np.concatenate([first, first + sub - 1])


def grazing_case(seed: int, width: int = 72, height: int = 40, *,
                 exact: bool = True) -> Case:
    """Ellipses whose a_raw ≥ 1/255 region is tangent to a column or row
    of pixel centres on a sub-tile edge (axis-aligned and rotated), from
    inside or outside; opacities just above 1/255; needle conics with
    det → 0⁺; non-PD and degenerate conics; radii larger than the image;
    and an opaque cluster whose pixels reach the 1e-4 stop at a high α.

    exact: the tangent pixel centre sits on the boundary itself (σ = L up
    to rounding: the cull mask must keep it, whichever way fp32 rounds);
    else it sits 0.002-0.02 px inside, so that the kernel and its plain
    version, whose roundings differ, agree on it."""
    rng = np.random.default_rng(seed)
    xs, ys = _edges(width, tr.SUB_W), _edges(height, tr.SUB_H)
    rows = []

    def tangent(n, rotated, along_x):
        a = 10 ** rng.uniform(-2.0, 0.3, n)
        c = 10 ** rng.uniform(-2.0, 0.3, n)
        b = (rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c) if rotated
             else np.zeros(n))
        o = rng.uniform(0.03, 0.9, n)
        level = np.log(255.0 * o)
        det = a * c - b * b
        side = rng.choice([-1.0, 1.0], n)
        inset = 0.0 if exact else rng.uniform(0.002, 0.02, n)
        if along_x:     # the extreme in x: dx = ±ex, dy = −(b/c)·dx
            ext = np.sqrt(2 * level * c / det)
            edge = rng.choice(xs, n)
            other = rng.choice(np.arange(height) + 0.5, n)
            mx = edge - side * (ext - inset)
            my = other + side * (b / c) * ext
        else:           # the extreme in y: dy = ±ey, dx = −(b/a)·dy
            ext = np.sqrt(2 * level * a / det)
            edge = rng.choice(ys, n)
            other = rng.choice(np.arange(width) + 0.5, n)
            my = edge - side * (ext - inset)
            mx = other + side * (b / a) * ext
        rows.append(_rows(np.stack([mx, my], 1), np.stack([a, b, c], 1), o,
                          rng))

    for rotated in (False, True):
        for along_x in (True, False):
            tangent(24, rotated, along_x)
    # opacities just above 1/255: a region of a pixel or less
    n = 12
    o = (1 / 255) * (1 + 10 ** rng.uniform(-6, -3, n))
    mean = np.stack([rng.choice(xs, n) + rng.uniform(-0.5, 0.5, n),
                     rng.choice(ys, n) + rng.uniform(-0.5, 0.5, n)], 1)
    rows.append(_rows(mean, np.tile([0.5, 0.0, 0.5], (n, 1)), o, rng))
    # needles: det → 0⁺ (det/ac from 1e-7 to 1e-3), at any angle
    n = 8 if exact else 4
    s = 10 ** rng.uniform(-1.0, 0.5, n)
    gap = 10 ** (rng.uniform(-7, -3, n) if exact else rng.uniform(-3, -2, n))
    b = rng.choice([-1.0, 1.0], n) * s * np.sqrt(1 - gap)
    mean = np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], 1)
    rows.append(_rows(mean, np.stack([s, b, s], 1),
                      rng.uniform(0.05, 0.5, n), rng))
    # non-PD and degenerate conics: b² > ac, det = 0, a < 0, a = 0
    conics = [[0.5, 0.9, 0.5], [1.0, 1.0, 1.0], [-0.3, 0.0, 0.4],
              [0.0, 0.0, 0.2], [0.2, -0.5, 0.3]]
    n = len(conics)
    mean = np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], 1)
    rows.append(_rows(mean, conics, rng.uniform(0.05, 0.3, n), rng))
    # radii larger than the image
    n = 3
    mean = np.stack([rng.uniform(-50, width + 50, n),
                     rng.uniform(-50, height + 50, n)], 1)
    rows.append(_rows(mean, np.tile([1e-5, 0.0, 2e-5], (n, 1)),
                      rng.uniform(0.02, 0.05, n), rng))
    tangents = np.concatenate(rows)
    # first in depth order: an opaque cluster over the first tile, whose
    # central pixels stop within its eight splats at a high α
    n = 8
    opaque = _rows(np.tile([8.0, 8.0], (n, 1)),
                   np.tile([0.03, 0.0, 0.03], (n, 1)),
                   rng.uniform(0.995, 0.998, n), rng)
    return all_pairs(np.concatenate([opaque, tangents]), width, height)


def small_splats_case(seed: int, n: int = 400, width: int = 64,
                      height: int = 64) -> Case:
    """Splats of 1-3 px, opacities 0.1-0.9: each touches a few sub-tiles."""
    rng = np.random.default_rng(seed)
    sd = rng.uniform(1.0, 3.0, (n, 2))
    rho = rng.uniform(-0.5, 0.5, n)
    cov = np.stack([sd[:, 0] ** 2, rho * sd[:, 0] * sd[:, 1],
                    sd[:, 1] ** 2], 1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conic = np.stack([cov[:, 2], -cov[:, 1], cov[:, 0]], 1) / det[:, None]
    mean = np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], 1)
    return all_pairs(_rows(mean, conic, rng.uniform(0.1, 0.9, n), rng),
                     width, height)


def long_segment_case(seed: int, n: int = 3000) -> Case:
    """A 32×32 image whose 4 tiles each walk all `n` faint splats (over ten
    stages of 256 pairs): no pixel reaches the stop."""
    rng = np.random.default_rng(seed)
    s = 1.0 / rng.uniform(1.0, 2.5, n) ** 2
    mean = rng.uniform(0, 32, (n, 2))
    rows = _rows(mean, np.stack([s, np.zeros(n), s], 1),
                 rng.uniform(0.01, 0.04, n), rng)
    return all_pairs(rows, 32, 32)


def early_stop_case(seed: int, n: int = 2000) -> Case:
    """A 32×32 image whose first two splats are opaque and cover it all, so
    every pixel stops within the first stage; `n` more splats follow."""
    rng = np.random.default_rng(seed)
    wide = _rows(np.tile([16.0, 16.0], (2, 1)),
                 np.tile([1e-5, 0.0, 1e-5], (2, 1)), [0.995, 0.995], rng)
    s = 1.0 / rng.uniform(1.0, 3.0, n) ** 2
    rest = _rows(rng.uniform(0, 32, (n, 2)), np.stack([s, np.zeros(n), s], 1),
                 rng.uniform(0.1, 0.9, n), rng)
    return all_pairs(np.concatenate([wide, rest]), 32, 32)


def passing(case: Case, exact_sigma: bool = False) -> torch.Tensor:
    """(256, P) whether each pixel of a pair's tile (row-major; those
    outside the image too) passes the composite's tests σ ≥ 0 and
    a_raw ≥ 1/255 for the pair.  fp32 as `composite_ref` computes, or with
    σ and a_raw exact (float64) from the fp32 dx, dy, as an FMA-contracting
    kernel may come closer to."""
    gid, bounds, table, ntx, _, _ = case
    p = torch.arange(tr.PIX)
    out = torch.zeros(tr.PIX, gid.numel(), dtype=torch.bool)
    starts = bounds.tolist()
    for t in range(len(starts) - 1):
        ty, tx = divmod(t, ntx)
        fx = (tx * tr.TILE + p % tr.TILE).float()[:, None] + 0.5
        fy = (ty * tr.TILE + p // tr.TILE).float()[:, None] + 0.5
        a = table[gid[starts[t]:starts[t + 1]].long()]
        dx, dy = fx - a[:, 0], fy - a[:, 1]
        if exact_sigma:
            dx, dy, a = dx.double(), dy.double(), a.double()
        sigma = 0.5 * (a[:, 2] * dx * dx + a[:, 4] * dy * dy) \
            + a[:, 3] * dx * dy
        a_raw = a[:, 5] * torch.exp(-sigma)
        out[:, starts[t]:starts[t + 1]] = \
            (sigma >= 0) & (a_raw >= np.float32(tr.ALPHA_MIN))
    return out


def warp_bits(mask: torch.Tensor) -> torch.Tensor:
    """(256, P) whether each pixel's warp walks each pair of its tile."""
    return ((mask[None, :] >> tr.pixel_warp()[:, None]) & 1).bool()


def cull_share(mask: torch.Tensor) -> float:
    """The share of (warp, pair)s the mask drops."""
    kept = sum(int(((mask >> w) & 1).sum()) for w in range(tr.N_WARPS))
    return 1.0 - kept / (tr.N_WARPS * mask.numel())
