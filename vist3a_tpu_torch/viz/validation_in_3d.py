"""3-D validation views: axis-aligned Gaussian projections and camera-pose
plots.

Port of `vist3a_tpu/viz/validation_in_3d.py` (the reference's
`src/visualization/validation_in_3d.py`).  The reference's orthographic
render (`cuda_splatting.render_cuda_orthographic`) is a fake one: a 10°
field of view and the camera moved back by 0.5·width / tan(fov_x / 2), so
that perspective is negligible.  The cameras are built on the host in
float64, exactly as the JAX package builds them, and rendered through the
port's `nn/splat_decoder.render` (the composite kernel on the card, one
launch a view and axis).  The scene's box is taken over the Gaussians of
opacity > 0 only: the encoder keeps every pixel's Gaussian and folds its
confidence mask into a zero opacity, which must not stretch the box.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vist3a_tpu_torch.nn.gaussians import Gaussians
from vist3a_tpu_torch.nn.splat_decoder import render
from vist3a_tpu_torch.viz.annotation import add_label
from vist3a_tpu_torch.viz.drawing import (compute_equal_aabb_with_margin,
                                          draw_cameras)

FOV_DEGREES = 10.0


def pad(images: list[np.ndarray]) -> list[np.ndarray]:
    """Pad a list of arrays to their elementwise-max shape with ones
    (`validation_in_3d.py:12-23`)."""
    shapes = np.stack([np.array(x.shape) for x in images])
    padded = shapes.max(axis=0)
    results = []
    for image in images:
        out = np.ones(padded.tolist(), dtype=image.dtype)
        sel = tuple(slice(0, s) for s in image.shape)
        out[sel] = image
        results.append(out)
    return results


def _fake_ortho_camera(extrinsics: np.ndarray, width: np.ndarray,
                       height: np.ndarray, fov_degrees: float):
    """Orthographic-by-distance camera (`cuda_splatting.py:174-185`):
    (c2w moved back along its z, normalised pinhole K), float64."""
    b = extrinsics.shape[0]
    tan_fov_x = math.tan(0.5 * math.radians(fov_degrees))
    distance = 0.5 * np.asarray(width) / tan_fov_x          # (B,)
    tan_fov_y = 0.5 * np.asarray(height) / distance

    move_back = np.tile(np.eye(4), (b, 1, 1))
    move_back[:, 2, 3] = -distance
    c2w = extrinsics @ move_back

    k = np.zeros((b, 3, 3), np.float64)
    k[:, 0, 0] = 0.5 / tan_fov_x                            # fx / W
    k[:, 1, 1] = 0.5 / tan_fov_y                            # fy / H
    k[:, 0, 2] = k[:, 1, 2] = 0.5
    k[:, 2, 2] = 1.0
    return c2w, k


def projection_cameras(gaussians: Gaussians, margin: float = 0.1) -> list:
    """The three fake orthographic cameras of `render_projections`, one a
    world axis it looks down: [(c2w (B, 4, 4), K (B, 3, 3), label), ...],
    float64 numpy.  The box is the live Gaussians' (opacity > 0), [0, 1]³
    where a batch entry has none."""
    means = gaussians.means.detach().double()               # (B, G, 3)
    live = gaussians.opacities.detach() > 0.0               # (B, G)
    b = means.shape[0]
    big = torch.tensor(torch.finfo(torch.float64).max, dtype=torch.float64,
                       device=means.device)
    lo = torch.where(live[..., None], means, big).amin(1).cpu().numpy()
    hi = torch.where(live[..., None], means, -big).amax(1).cpu().numpy()
    any_live = live.any(1).cpu().numpy()
    minima = np.where(any_live[:, None], lo, np.zeros((b, 3)))
    maxima = np.where(any_live[:, None], hi, np.ones((b, 3)))
    scene_min, scene_max = compute_equal_aabb_with_margin(minima, maxima,
                                                          margin)
    cameras = []
    for look in range(3):
        right, down = (look + 1) % 3, (look + 2) % 3
        extr = np.zeros((b, 4, 4), np.float64)
        extr[:, right, 0] = 1.0                              # cam x → right
        extr[:, down, 1] = 1.0                               # cam y → down
        extr[:, look, 2] = 1.0                               # cam z → look
        extr[:, right, 3] = 0.5 * (scene_min[:, right] + scene_max[:, right])
        extr[:, down, 3] = 0.5 * (scene_min[:, down] + scene_max[:, down])
        extr[:, look, 3] = scene_min[:, look]
        extr[:, 3, 3] = 1.0
        extents = scene_max - scene_min
        c2w, k = _fake_ortho_camera(extr, extents[:, right],
                                    extents[:, down], FOV_DEGREES)
        cameras.append((c2w, k, f"{'XYZ'[right]}{'XYZ'[down]} Projection"))
    return cameras


def render_projections(gaussians: Gaussians, resolution: int,
                       margin: float = 0.1, draw_label: bool = True,
                       extra_label: str = "", *,
                       device: torch.device | str = "cuda") -> np.ndarray:
    """The scene's Gaussians rendered orthographically down each world axis
    → (B, 3, 3, H', W') numpy (`validation_in_3d.py:26-105`)."""
    projections = []
    with torch.inference_mode():
        for c2w, k, name in projection_cameras(gaussians, margin):
            out = render(gaussians,
                         torch.from_numpy(c2w.astype(np.float32))[:, None],
                         torch.from_numpy(k.astype(np.float32))[:, None],
                         (resolution, resolution), device=device)
            imgs = out.color[:, 0].cpu().numpy()             # (B, 3, H, W)
            if draw_label:
                label = f"{name} {extra_label}".strip()
                imgs = np.stack([add_label(x, label) for x in imgs])
            projections.append(imgs)
    return np.stack(pad(projections), axis=1)


def render_camera_poses(batch: dict, resolution: int, *,
                        device: torch.device | str = "cuda") -> np.ndarray:
    """Context (white) and target (red) camera frustums on the three axis
    planes → (3, 3, res', res') numpy (`validation_in_3d.py:108-131`)."""
    ctx, tgt = batch["context"], batch["target"]
    n_ctx = np.asarray(ctx["extrinsics"]).shape[1]
    n_tgt = np.asarray(tgt["extrinsics"]).shape[1]
    color = np.ones((n_ctx + n_tgt, 3), np.float32)
    color[n_ctx:, 1:] = 0.0                                  # targets red

    return draw_cameras(
        resolution,
        np.concatenate([np.asarray(ctx["extrinsics"])[0],
                        np.asarray(tgt["extrinsics"])[0]]),
        np.concatenate([np.asarray(ctx["intrinsics"])[0],
                        np.asarray(tgt["intrinsics"])[0]]),
        color,
        np.concatenate([np.asarray(ctx["near"])[0],
                        np.asarray(tgt["near"])[0]]),
        np.concatenate([np.asarray(ctx["far"])[0],
                        np.asarray(tgt["far"])[0]]),
        device=device)
