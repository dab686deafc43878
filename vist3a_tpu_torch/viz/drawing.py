"""Anti-aliased 2-D primitives: lines, points, camera frustums.

Port of `vist3a_tpu/viz/drawing.py` (the reference's
`src/visualization/drawing/`).  Coverage is analytic, as in the JAX
package: a primitive's alpha is clip(r − sdf + ½, 0, 1), the exact-area
approximation of a one-pixel antialiasing band (the reference estimates it
by recursive MSAA, a documented deviation of the JAX package).  The JAX
package paints with a `lax.scan` in index order; here the same result is
computed on the device in fp32, vectorised over chunks of primitives: the
top colour of a pixel is the colour of the highest-indexed primitive whose
alpha there is > 0 (black if none), the overlay alpha the per-pixel max,
blended over the image as straight alpha.

The camera helpers (`unproject_frustum_corners`, `compute_aabb`,
`compute_equal_aabb_with_margin`) are host numpy in float64, equal to the
JAX package's bit for bit.  `draw_lines` and `draw_points` return a tensor
on `device`; `draw_cameras` returns numpy, its labels drawn on the host.
"""

from __future__ import annotations

import numpy as np
import torch

# pixels × primitives held at once while painting (fp32 temporaries of a
# few hundred MB at most)
_CHUNK_PIXELS = 1 << 24


def _pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """Pixel-centre sample grid, (H, W, 2) xy (`rendering.py:18-26`)."""
    x = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _world_to_pixel(xy: torch.Tensor, shape: tuple[int, int],
                    x_range, y_range) -> torch.Tensor:
    """Map world xy into pixel space (`coordinate_conversion.py:19-44`):
    identity without ranges, else an affine fit of (x_range, y_range) onto
    (0..w, 0..h), in fp32."""
    h, w = shape
    xr = (0.0, float(w)) if x_range is None else x_range
    yr = (0.0, float(h)) if y_range is None else y_range
    f32 = np.float32
    minima = torch.tensor([f32(xr[0]), f32(yr[0])], device=xy.device)
    maxima = torch.tensor([f32(xr[1]), f32(yr[1])], device=xy.device)
    wh = torch.tensor([w, h], dtype=torch.float32, device=xy.device)
    return (xy - minima) / (maxima - minima) * wh


def _broadcast_rows(arr, n: int, dim: int, device) -> torch.Tensor:
    """Scalars / vectors → (n, dim) float32 on `device` (`types.py:18-52`)."""
    a = torch.as_tensor(arr if isinstance(arr, torch.Tensor)
                        else np.asarray(arr, np.float32),
                        dtype=torch.float32, device=device)
    while a.ndim < 2:
        a = a[None]
    if a.shape[-1] == 1 and dim > 1:
        a = a.expand(*a.shape[:-1], dim)
    return a.expand(n, dim)


def _composite(image: torch.Tensor, colors: torch.Tensor, alphas_fn,
               n: int) -> torch.Tensor:
    """Paint n primitives in index order: alphas_fn(lo, hi, grid) → the
    alphas (hi − lo, H, W) of primitives [lo, hi)."""
    _, h, w = image.shape
    grid = _pixel_grid(h, w, image.device)
    top = torch.zeros(3, h, w, device=image.device)
    amax = torch.zeros(h, w, device=image.device)
    chunk = max(1, _CHUNK_PIXELS // (h * w))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        a = alphas_fn(lo, hi, grid)
        index = torch.arange(hi - lo, device=image.device)[:, None, None]
        last = torch.where(a > 0.0, index, -1).amax(0)
        hit = last >= 0
        top = torch.where(hit[None], colors[lo:hi][last.clamp_min(0)]
                          .permute(2, 0, 1), top)
        amax = torch.maximum(amax, a.amax(0))
    return image * (1.0 - amax[None]) + top * amax[None]


def draw_lines(image, start, end, color, width, cap: str = "round",
               x_range=None, y_range=None, num_msaa_passes: int = 1, *,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Anti-aliased line segments over a (3, H, W) image (`lines.py:14-84`).
    `cap` ∈ {butt, round, square}; `num_msaa_passes` is accepted for the
    interface (coverage is analytic)."""
    del num_msaa_passes
    image = torch.as_tensor(image, dtype=torch.float32).to(device)
    _, h, w = image.shape
    n = int(np.broadcast_shapes(tuple(np.shape(start)[:-1]) or (1,),
                                tuple(np.shape(end)[:-1]) or (1,))[0])
    n = max(n, np.shape(color)[0] if np.ndim(color) == 2 else 1,
            np.shape(width)[0] if np.ndim(width) == 1 else 1)
    start = _world_to_pixel(_broadcast_rows(start, n, 2, image.device),
                            (h, w), x_range, y_range)
    end = _world_to_pixel(_broadcast_rows(end, n, 2, image.device), (h, w),
                          x_range, y_range)
    colors = _broadcast_rows(color, n, 3, image.device)
    widths = _broadcast_rows(width, n, 1, image.device)[:, 0]

    def alphas(lo, hi, grid):
        s = start[lo:hi, None, None]                      # (n, 1, 1, 2)
        d = end[lo:hi, None, None] - s
        r = 0.5 * widths[lo:hi, None, None]
        length = torch.linalg.vector_norm(d, dim=-1)      # (n, 1, 1)
        u = d / torch.clamp_min(length, 1e-12)[..., None]
        rel = grid - s
        t = rel[..., 0] * u[..., 0] + rel[..., 1] * u[..., 1]
        if cap == "square":
            tc = torch.minimum(torch.maximum(t, -r), length + r)
        else:                                         # round, butt
            tc = torch.minimum(torch.clamp_min(t, 0.0), length)
        closest = s + tc[..., None] * u
        dist = torch.linalg.vector_norm(grid - closest, dim=-1)
        if cap == "butt":
            # no cap: samples beyond the endpoints along the segment are
            # out (`lines.py:55-58` with extra = 0)
            dist = torch.where((t > 0.0) & (t <= length), dist, torch.inf)
        return torch.clamp(r - dist + 0.5, 0.0, 1.0)

    return _composite(image, colors, alphas, n)


def draw_points(image, points, color=(1.0, 1.0, 1.0), radius=1,
                inner_radius=0, x_range=None, y_range=None,
                num_msaa_passes: int = 1, *,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Anti-aliased discs / annuli over a (3, H, W) image
    (`points.py:14-60`)."""
    del num_msaa_passes
    image = torch.as_tensor(image, dtype=torch.float32).to(device)
    _, h, w = image.shape
    pts = np.atleast_2d(np.asarray(points, np.float32))
    n = pts.shape[0]
    centers = _world_to_pixel(_broadcast_rows(pts, n, 2, image.device),
                              (h, w), x_range, y_range)
    colors = _broadcast_rows(color, n, 3, image.device)
    r_out = _broadcast_rows(radius, n, 1, image.device)[:, 0]
    r_in = _broadcast_rows(inner_radius, n, 1, image.device)[:, 0]

    def alphas(lo, hi, grid):
        dist = torch.linalg.vector_norm(grid - centers[lo:hi, None, None],
                                        dim=-1)
        outer = torch.clamp(r_out[lo:hi, None, None] - dist + 0.5, 0.0, 1.0)
        inner = torch.clamp(r_in[lo:hi, None, None] - dist + 0.5, 0.0, 1.0)
        return outer * (1.0 - inner)

    return _composite(image, colors, alphas, n)


# --------------------------------------------------------------------------- #
# camera frustum wireframes (`cameras.py`)                                    #
# --------------------------------------------------------------------------- #
def unproject_frustum_corners(extrinsics: np.ndarray, intrinsics: np.ndarray,
                              depth: np.ndarray) -> np.ndarray:
    """(B, 4, 4) c2w + (B, 3, 3) normalised K + (B,) z-depth → (B, 4, 3)
    world corners of the image rectangle, circularly ordered
    (`cameras.py:166-195`)."""
    b = extrinsics.shape[0]
    xy = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    ones = np.ones((4, 1))
    pix = np.concatenate([xy, ones], axis=-1)               # (4, 3)
    kinv = np.linalg.inv(intrinsics)                        # (B, 3, 3)
    dirs = np.einsum("bij,pj->bpi", kinv, pix)
    dirs = dirs / dirs[..., 2:3]                            # z-depth scaling
    dirs = np.einsum("bij,bpj->bpi", extrinsics[:, :3, :3], dirs)
    origins = extrinsics[:, None, :3, 3]
    return origins + np.asarray(depth).reshape(b if np.ndim(depth) else 1,
                                               1, 1) * dirs


def compute_aabb(extrinsics, intrinsics, near=None, far=None):
    """AABB of the camera origins and the near / far rectangles' corners
    (`cameras.py:124-152`)."""
    points = [extrinsics[:, :3, 3]]
    for depth in (near, far):
        if depth is not None:
            d = np.broadcast_to(np.asarray(depth, np.float64),
                                (extrinsics.shape[0],))
            points.append(
                unproject_frustum_corners(extrinsics, intrinsics,
                                          d).reshape(-1, 3))
    pts = np.concatenate(points, axis=0)
    return pts.min(axis=0), pts.max(axis=0)


def compute_equal_aabb_with_margin(minima, maxima, margin: float = 0.1):
    """A cube around the AABB's midpoint with a relative margin
    (`cameras.py:155-163`)."""
    minima, maxima = np.asarray(minima), np.asarray(maxima)
    mid = 0.5 * (maxima + minima)
    span = (maxima - minima).max() * (1.0 + margin)
    return mid - 0.5 * span, mid + 0.5 * span


def draw_cameras(resolution: int, extrinsics, intrinsics, color,
                 near=None, far=None, margin: float = 0.1,
                 frustum_scale: float = 0.05, *,
                 device: torch.device | str = "cuda") -> np.ndarray:
    """Camera frustum wireframes projected on the three axis-aligned planes
    → (3, 3, res', res') numpy (`cameras.py:15-121`), each plane labelled
    and padded to the largest.  The near / far rectangles (when given) are
    grey (0.25), under the per-camera coloured frustums."""
    from vist3a_tpu_torch.viz.annotation import add_label

    extrinsics = np.asarray(extrinsics, np.float64)
    intrinsics = np.asarray(intrinsics, np.float64)
    color = np.asarray(color, np.float32)
    b = extrinsics.shape[0]

    minima, maxima = compute_aabb(extrinsics, intrinsics, near, far)
    scene_min, scene_max = compute_equal_aabb_with_margin(minima, maxima,
                                                          margin)
    span = (scene_max - scene_min).max()

    corner_depth = np.full((b,), span * frustum_scale)
    frustum = unproject_frustum_corners(extrinsics, intrinsics, corner_depth)
    near_c = far_c = None
    if near is not None:
        near_c = unproject_frustum_corners(
            extrinsics, intrinsics,
            np.broadcast_to(np.asarray(near, np.float64), (b,)))
    if far is not None:
        far_c = unproject_frustum_corners(
            extrinsics, intrinsics,
            np.broadcast_to(np.asarray(far, np.float64), (b,)))

    projections = []
    for axis in range(3):
        xa, ya = (axis + 1) % 3, (axis + 2) % 3

        def project(p):
            return np.stack([p[..., xa], p[..., ya]], axis=-1)

        ranges = {"x_range": (scene_min[xa], scene_max[xa]),
                  "y_range": (scene_min[ya], scene_max[ya]),
                  "device": device}
        image = torch.zeros(3, resolution, resolution)

        for corners in (near_c, far_c):
            if corners is not None:
                pc = project(corners)
                image = draw_lines(
                    image, pc.reshape(-1, 2),
                    np.roll(pc, 1, axis=1).reshape(-1, 2), color=0.25,
                    width=2, **ranges)
        if near_c is not None and far_c is not None:
            image = draw_lines(
                image, project(near_c).reshape(-1, 2),
                project(far_c).reshape(-1, 2), color=0.25, width=2,
                **ranges)

        # frustum edges: 4 origin→corner rays and the 4-corner rectangle
        po = project(extrinsics[:, :3, 3])                  # (B, 2)
        pf = project(frustum)                               # (B, 4, 2)
        start = np.concatenate(
            [np.repeat(po[:, None], 4, axis=1),             # rays
             np.roll(pf, 1, axis=1)], axis=1)               # rectangle
        end = np.concatenate([pf, pf], axis=1)              # (B, 8, 2)
        line_color = np.repeat(color[:, None], 8, axis=1)
        image = draw_lines(image, start.reshape(-1, 2), end.reshape(-1, 2),
                           color=line_color.reshape(-1, 3), width=2,
                           **ranges)

        labeled = add_label(image.cpu().numpy(),
                            f"{'XYZ'[xa]}{'XYZ'[ya]} Projection")
        projections.append(labeled)

    # label widths vary per text: pad to the common max before stacking
    shape = np.stack([np.array(p.shape) for p in projections]).max(axis=0)
    padded = []
    for p in projections:
        out = np.ones(shape.tolist(), np.float32)
        out[tuple(slice(0, s) for s in p.shape)] = p
        padded.append(out)
    return np.stack(padded)
