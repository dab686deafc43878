"""Camera-path interpolation and the orbit-video export.

Port of `vist3a_tpu/io/video_export.py`: t in-between cameras per adjacent
pair (lerped translation and intrinsics, SVD-orthogonalised lerped
rotations, numpy float64), rendered through the splatting decoder; a colour
video and a turbo-coloured depth video at 20 fps.

The mp4 writer is imageio, else OpenCV, as in the JAX package; the turbo
colormap is this package's copy of matplotlib's (`io/turbo.py`), so
rendering, frame conversion and colouring need neither.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from vist3a_tpu_torch.io.turbo import turbo
from vist3a_tpu_torch.nn.splat_decoder import render


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
    """Interpolate the cameras, render the orbit on `device`, and write
    gs.mp4 and depth.mp4 into `save_path`.  Each stage is a
    `torch.profiler` range named `export.*`."""
    with record_function("export.cameras"):
        ex, kk = interpolate_cameras(_host(extrinsics_c2w),
                                     _host(intrinsics_norm), t)
    with record_function("export.render"), torch.inference_mode():
        out = render(gaussians, torch.from_numpy(ex), torch.from_numpy(kk),
                     image_shape, device=device)
    with record_function("export.frames_to_host"):
        color = out.color[0].cpu().numpy()
        depth = out.depth[0].cpu().numpy()
    with record_function("export.colour_uint8"):
        gs_frames = to_uint8_frames(color)
    with record_function("export.turbo_uint8"):
        depth_frames = to_uint8_frames(
            turbo_depth(depth, extrinsics_c2w.shape[1]))
    with record_function("export.mp4_write"):
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
