"""3DGS-standard PLY export and its reader.

Port of `vist3a_tpu/io/ply_export.py` (numpy only; torch tensors are read
on the host) with its defaults, which the export uses: vertex attributes
x, y, z, nx, ny, nz (zeros), f_dc_{0..2} (the DC band only), opacity,
scale_{0..2} (log), rot_{0..3} (wxyz quaternion), binary little-endian
float32, no shift-and-scale.  The bytes equal the JAX package's for the
same arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


NAMES = (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
         + ["opacity"] + [f"scale_{i}" for i in range(3)]
         + [f"rot_{i}" for i in range(4)])


def export_ply(means, scales, rotations_xyzw, harmonics, opacities,
               path) -> Path:
    """means (G, 3), scales (G, 3) linear, rotations (G, 4) xyzw,
    harmonics (G, 3, d_sh), opacities (G,) → a PLY with the DC band, wxyz
    quaternions and log scales."""
    path = Path(path)
    means = _host(means)
    scales = _host(scales)
    rot = _host(rotations_xyzw)
    f_dc = _host(harmonics[..., 0])     # only the DC band leaves the card
    opacities = _host(opacities)

    rot = rot / np.maximum(np.linalg.norm(rot, axis=-1, keepdims=True), 1e-12)
    rot_wxyz = np.concatenate([rot[:, 3:4], rot[:, :3]], axis=-1)
    cols = [means, np.zeros_like(means), f_dc, opacities[:, None],
            np.log(np.maximum(scales, 1e-20)), rot_wxyz]
    data = np.ascontiguousarray(np.concatenate(cols, axis=1), np.float32)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(means)}"]
    header += [f"property float {n}" for n in NAMES]
    header += ["end_header", ""]

    path.parent.mkdir(exist_ok=True, parents=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())
    return path


def load_ply(path) -> dict[str, np.ndarray]:
    """Inverse of export_ply: attribute name → (G,) float32 array."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h.split()[-1] for h in header
                     if h.startswith("element vertex")))
        names = [h.split()[-1] for h in header
                 if h.startswith("property float")]
        data = np.frombuffer(f.read(), np.float32).reshape(n, len(names))
    return {name: data[:, i] for i, name in enumerate(names)}
