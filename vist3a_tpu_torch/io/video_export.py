"""Camera-path interpolation and the orbit-video export.

Port of `vist3a_tpu/io/video_export.py`: t in-between cameras per adjacent
pair (lerped translation and intrinsics, SVD-orthogonalised lerped
rotations, numpy float64), rendered through the splatting decoder; a colour
video and a turbo-coloured depth video at 20 fps.

The mp4 writer is imageio, else OpenCV, as in the JAX package; the turbo
colormap is this package's copy of matplotlib's (`io/turbo.py`), so
rendering, frame conversion and colouring need neither.  The export makes
both videos' uint8 frames on the render's device (`orbit_uint8_frames`),
byte for byte what the numpy functions `to_uint8_frames` and
`turbo_depth` give.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from vist3a_tpu_torch.core.profiling import span
from vist3a_tpu_torch.io.turbo import TURBO, turbo
from vist3a_tpu_torch.nn.splat_decoder import render

# `to_uint8_frames` of each turbo colour, and black for NaN in row 256
TURBO_UINT8 = np.concatenate([
    (np.clip(np.asarray(TURBO, np.float64), 0, 1) * 255).astype(np.uint8),
    np.zeros((1, 3), np.uint8)])

# frames `orbit_uint8_frames` converted (colour and depth each count)
frames_on_card = 0


def reset_frame_counts() -> None:
    global frames_on_card
    frames_on_card = 0


def interpolate_cameras(extrinsics_c2w, intrinsics_norm, t: int = 10):
    """(B, V, 4, 4), (B, V, 3, 3) → (B, V', 4, 4), (B, V', 3, 3) float32
    with V' = (V−1)·(t+1) + 1: the last frame is kept once."""
    ex = np.asarray(extrinsics_c2w, np.float64)
    kk = np.asarray(intrinsics_norm, np.float64)
    b, v = ex.shape[:2]
    out_e, out_k = [], []
    for i in range(v - 1):
        out_e.append(ex[:, i])
        out_k.append(kk[:, i])
        for j in range(1, t + 1):
            alpha = j / (t + 1)
            rot = (1 - alpha) * ex[:, i, :3, :3] + alpha * ex[:, i + 1, :3, :3]
            u, _, vt = np.linalg.svd(rot)
            rot = u @ vt
            trans = (1 - alpha) * ex[:, i, :3, 3] + alpha * ex[:, i + 1, :3, 3]
            e = np.broadcast_to(np.eye(4), (b, 4, 4)).copy()
            e[:, :3, :3] = rot
            e[:, :3, 3] = trans
            out_e.append(e)
            out_k.append((1 - alpha) * kk[:, i] + alpha * kk[:, i + 1])
    out_e.append(ex[:, -1])
    out_k.append(kk[:, -1])
    return (np.stack(out_e, 1).astype(np.float32),
            np.stack(out_k, 1).astype(np.float32))


def to_uint8_frames(frames: np.ndarray) -> np.ndarray:
    """(N, 3, H, W) floats in [0, 1] → (N, H, W, 3) uint8."""
    return (np.clip(np.transpose(np.asarray(frames), (0, 2, 3, 1)), 0, 1)
            * 255).astype(np.uint8)


def write_mp4(video: np.ndarray, path, fps: int = 20) -> str:
    """(N, H, W, 3) uint8 → mp4: imageio (ffmpeg) when present, else an
    OpenCV VideoWriter."""
    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    try:
        import imageio

        writer = imageio.get_writer(str(path), fps=fps)
        for frame in video:
            writer.append_data(frame)
        writer.close()
    except (ImportError, ValueError):
        import cv2

        h, w = video.shape[1:3]
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        for frame in video:
            writer.write(frame[..., ::-1])     # RGB → BGR
        writer.release()
    return str(path)


def turbo_depth(depth: np.ndarray, num_views: int) -> np.ndarray:
    """Normalise by the 1 % / 99 % quantiles of every `num_views`-th frame
    and colour with turbo → (N, 3, H, W) float64."""
    d = np.asarray(depth, np.float32)
    keys = d[::num_views]
    lo, hi = np.quantile(keys, 0.01), np.quantile(keys, 0.99)
    dn = (d - lo) / max(hi - lo, 1e-12)
    return np.clip(np.transpose(turbo(dn), (0, 3, 1, 2)), 0, 1)


def orbit_uint8_frames(color: torch.Tensor, depth: torch.Tensor,
                       num_views: int) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3, H, W) colour and (N, H, W) depth on their device → the gs
    and depth videos' (N, H, W, 3) uint8 frames on the host, byte for byte
    `to_uint8_frames(color)` and `to_uint8_frames(turbo_depth(depth,
    num_views))`: numpy's float32 arithmetic on the device, numpy's own
    quantiles of the key frames, and each turbo bin one row of
    `TURBO_UINT8`.  Only uint8 frames (and the key frames) cross to the
    host.  Spans `export.colour_uint8`, `export.turbo_uint8`."""
    global frames_on_card
    with torch.inference_mode():
        with span("export.colour_uint8"):
            gs = color.clamp(0, 1).mul_(255).to(torch.uint8)
            gs = gs.permute(0, 2, 3, 1).contiguous().cpu().numpy()
        with span("export.turbo_uint8"):
            d = depth.float()
            keys = d[::num_views].cpu().numpy()
            lo, hi = np.quantile(keys, 0.01), np.quantile(keys, 0.99)
            # both on the device: CUDA divides by a host scalar as a
            # multiply by its reciprocal, which is not numpy's division
            lo_t, scale_t = (torch.tensor(float(v), dtype=torch.float32,
                                          device=d.device)
                             for v in (lo, max(hi - lo, 1e-12)))
            x = (d - lo_t).div_(scale_t).mul_(len(TURBO))
            # turbo's bins: floor(x), x = 256 and above in the last, below
            # 0 in the first, NaN black
            idx = x.clamp_(0, len(TURBO) - 1).nan_to_num_(len(TURBO)).long()
            table = torch.from_numpy(TURBO_UINT8).to(d.device)
            depth_frames = table[idx].cpu().numpy()
    frames_on_card += len(gs) + len(depth_frames)
    return gs, depth_frames


class OrbitVideo(NamedTuple):
    gs_path: str
    depth_path: str
    color: np.ndarray         # (N, 3, H, W) in [0, 1]
    depth: np.ndarray         # (N, H, W)


def save_interpolated_video(extrinsics_c2w, intrinsics_norm, gaussians,
                            image_shape, save_path, *, t: int = 10,
                            fps: int = 20,
                            device: torch.device | str = "cuda"
                            ) -> OrbitVideo:
    """Interpolate the cameras, render the orbit on `device`, colour its
    frames there, and write gs.mp4 and depth.mp4 into `save_path`.  Each
    stage is a span (`core/profiling.span`) named `export.*`."""
    with span("export.cameras"):
        ex, kk = interpolate_cameras(_host(extrinsics_c2w),
                                     _host(intrinsics_norm), t)
    with span("export.render"), torch.inference_mode():
        out = render(gaussians, torch.from_numpy(ex), torch.from_numpy(kk),
                     image_shape, device=device)
    with span("export.frames_to_host"):
        color = out.color[0].cpu().numpy()
        depth = out.depth[0].cpu().numpy()
    gs_frames, depth_frames = orbit_uint8_frames(
        out.color[0], out.depth[0], extrinsics_c2w.shape[1])
    with span("export.mp4_write"):
        os.makedirs(save_path, exist_ok=True)
        gs_path = write_mp4(gs_frames, os.path.join(save_path, "gs.mp4"),
                            fps)
        depth_path = write_mp4(depth_frames,
                               os.path.join(save_path, "depth.mp4"), fps)
    return OrbitVideo(gs_path, depth_path, color, depth)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)
