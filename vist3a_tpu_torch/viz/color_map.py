"""Scalar-field colour maps.

Port of `vist3a_tpu/viz/color_map.py` (the reference's
`src/visualization/color_map.py`):

  * `apply_color_map` — matplotlib's named maps (default inferno) without
    matplotlib: the tables of matplotlib 3.10.8 are carried in
    `colormaps.npz` (written by `tools/torch_colormaps.py`; a `_r` map is
    its base table reversed).  A value is looked up as
    `ListedColormap.__call__` looks up floats: x clipped to [0, 1] and
    multiplied by N in float64, x·N = N kept in the last bin, the index
    truncated, NaN black.  It runs on numpy arrays (returned as numpy) or
    on tensors on their own device, with the same result;
  * `apply_color_map_2d` — red↔blue on x and colour↔white on y, lerped in
    CIELab (D65) and converted back to sRGB, host float64, the JAX
    package's inlined math.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

TABLES = Path(__file__).resolve().parent / "colormaps.npz"

# D65 2° white point and sRGB↔XYZ matrices (IEC 61966-2-1)
_WHITE = np.array([0.95047, 1.0, 1.08883])
_RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                     [0.2126729, 0.7151522, 0.0721750],
                     [0.0193339, 0.1191920, 0.9503041]])
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_DELTA = 6.0 / 29.0


@functools.cache
def _tables() -> dict[str, np.ndarray]:
    with np.load(TABLES) as f:
        return {k: f[k] for k in f.files if not k.startswith("__")}


def color_map_names() -> list[str]:
    """Every map `apply_color_map` knows, the `_r` ones included."""
    base = sorted(_tables())
    return base + [n + "_r" for n in base]


def color_map_table(name: str) -> np.ndarray:
    """(N, 3) float32 RGB table of a named map."""
    tables = _tables()
    if name in tables:
        return tables[name]
    if name.endswith("_r") and name[:-2] in tables:
        return tables[name[:-2]][::-1]
    raise KeyError(f"{name!r} is not a known colour map")


def apply_color_map(x, color_map: str = "inferno"):
    """(…,) values in [0, 1] → (…, 3) float32 RGB (`color_map.py:9-20`):
    numpy in, numpy out; a tensor in, a tensor out on its device."""
    table = color_map_table(color_map)
    n = table.shape[0]
    if isinstance(x, torch.Tensor):
        xa = torch.clamp(x.double(), 0.0, 1.0) * n
        xa = torch.where(xa == n, n - 1.0, xa)
        nan = torch.isnan(xa)
        idx = torch.where(nan, n, torch.nan_to_num(xa).long())
        lut = torch.cat([torch.from_numpy(np.ascontiguousarray(table)),
                         torch.zeros(1, 3)]).to(x.device)
        return lut[idx]
    xa = np.clip(np.asarray(x, np.float64), 0.0, 1.0) * n
    xa = np.where(xa == n, n - 1.0, xa)
    nan = np.isnan(xa)
    idx = np.where(nan, n, np.nan_to_num(xa).astype(np.int64))
    return np.concatenate([table, np.zeros((1, 3), np.float32)])[idx]


def apply_color_map_to_image(image, color_map: str = "inferno"):
    """(…, H, W) → (…, 3, H, W) channels-first (`color_map.py:23-28`)."""
    mapped = apply_color_map(image, color_map)
    if isinstance(mapped, torch.Tensor):
        return mapped.movedim(-1, -3)
    return np.moveaxis(mapped, -1, -3)


def _srgb_to_lab(rgb01: np.ndarray) -> np.ndarray:
    rgb01 = np.asarray(rgb01, np.float64)
    lin = np.where(rgb01 <= 0.04045, rgb01 / 12.92,
                   ((rgb01 + 0.055) / 1.055) ** 2.4)
    xyz = lin @ _RGB2XYZ.T / _WHITE
    f = np.where(xyz > _DELTA ** 3, np.cbrt(xyz),
                 xyz / (3 * _DELTA ** 2) + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                     200.0 * (fy - fz)], axis=-1)


def _lab_to_srgb(lab: np.ndarray) -> np.ndarray:
    lab = np.asarray(lab, np.float64)
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0
    f = np.stack([fx, fy, fz], axis=-1)
    xyz = np.where(f > _DELTA, f ** 3, 3 * _DELTA ** 2 * (f - 4.0 / 29.0))
    lin = (xyz * _WHITE) @ _XYZ2RGB.T
    lin = np.clip(lin, 0.0, None)
    return np.where(lin <= 0.0031308, 12.92 * lin,
                    1.055 * lin ** (1 / 2.4) - 0.055)


def apply_color_map_2d(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """2-D colour map (`color_map.py:31-48`): lerp red↔blue on x, then
    colour↔white on y, in CIELab; back to sRGB, clipped to [0, 1]."""
    red = _srgb_to_lab(np.array([189, 0, 0]) / 255.0)
    blue = _srgb_to_lab(np.array([0, 45, 255]) / 255.0)
    white = _srgb_to_lab(np.array([255, 255, 255]) / 255.0)
    xn = np.clip(np.asarray(x, np.float64), 0.0, 1.0)[..., None]
    yn = np.clip(np.asarray(y, np.float64), 0.0, 1.0)[..., None]
    lab = xn * red + (1.0 - xn) * blue
    lab = yn * lab + (1.0 - yn) * white
    return np.clip(_lab_to_srgb(lab), 0.0, 1.0).astype(np.float32)
