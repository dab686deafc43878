"""Image layout: borders, flexbox-style concatenation, overlay, resize.

Port of `vist3a_tpu/viz/layout.py` (the reference's
`src/visualization/layout.py`): float32 (channel, height, width) images on
the host, plain numpy, equal to the JAX package's bit for bit;
`resize_image` is OpenCV's INTER_AREA (down) or INTER_LINEAR (up).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

Alignment = str   # "start" | "center" | "end"
Axis = str        # "horizontal" | "vertical"

_MAIN_DIM = {"horizontal": 2, "vertical": 1}
_CROSS_DIM = {"horizontal": 1, "vertical": 2}


def _sanitize_color(color) -> np.ndarray:
    """Scalar / iterable / array → float32 (#channel,) vector
    (`layout.py:30-41`)."""
    arr = np.asarray(color, dtype=np.float32)
    if arr.ndim == 0:
        arr = arr[None]
    assert arr.ndim == 1
    return arr


def _offset_slice(base: int, child: int, align: Alignment) -> slice:
    assert base >= child, (base, child)
    offset = {"start": 0, "center": (base - child) // 2,
              "end": base - child}[align]
    return slice(offset, offset + child)


def overlay(base: np.ndarray, child: np.ndarray, main_axis: Axis,
            main_axis_alignment: Alignment,
            cross_axis_alignment: Alignment) -> np.ndarray:
    """Paste `child` onto `base` with per-axis alignment
    (`layout.py:76-105`)."""
    sel: list = [slice(None)] * 3
    md, cd = _MAIN_DIM[main_axis], _CROSS_DIM[main_axis]
    sel[md] = _offset_slice(base.shape[md], child.shape[md],
                            main_axis_alignment)
    sel[cd] = _offset_slice(base.shape[cd], child.shape[cd],
                            cross_axis_alignment)
    out = base.copy()
    out[tuple(sel)] = child
    return out


def cat(main_axis: Axis, *images: np.ndarray, align: Alignment = "center",
        gap: int = 8, gap_color=1) -> np.ndarray:
    """Arrange images in a line (CSS-flexbox-like; `layout.py:108-146`):
    pad every image to the max cross-axis extent with `gap_color`, align
    along the cross axis, intersperse `gap`-wide separators."""
    images = [np.asarray(im, dtype=np.float32) for im in images]
    color = _sanitize_color(gap_color)
    md, cd = _MAIN_DIM[main_axis], _CROSS_DIM[main_axis]
    cross = max(im.shape[cd] for im in images)

    padded = []
    for im in images:
        shape = list(im.shape)
        shape[cd] = cross
        base = np.ones(shape, np.float32) * color[:, None, None]
        padded.append(overlay(base, im, main_axis, "start", align))

    if gap > 0:
        c = images[0].shape[0]
        sep_shape = [c, gap, gap]
        sep_shape[cd] = cross
        sep = np.ones(sep_shape, np.float32) * color[:, None, None]
        with_gaps = []
        for i, im in enumerate(padded):
            if i:
                with_gaps.append(sep)
            with_gaps.append(im)
        padded = with_gaps
    return np.concatenate(padded, axis=md)


_HCAT_ALIGN = {"start": "start", "center": "center", "end": "end",
               "top": "start", "bottom": "end"}
_VCAT_ALIGN = {"start": "start", "center": "center", "end": "end",
               "left": "start", "right": "end"}


def hcat(*images: np.ndarray, align: str = "start", gap: int = 8,
         gap_color=1) -> np.ndarray:
    """Horizontal concatenation (`layout.py:149-169`)."""
    return cat("horizontal", *images, align=_HCAT_ALIGN[align], gap=gap,
               gap_color=gap_color)


def vcat(*images: np.ndarray, align: str = "start", gap: int = 8,
         gap_color=1) -> np.ndarray:
    """Vertical concatenation (`layout.py:172-192`)."""
    return cat("vertical", *images, align=_VCAT_ALIGN[align], gap=gap,
               gap_color=gap_color)


def add_border(image: np.ndarray, border: int = 8, color=1) -> np.ndarray:
    """Surround (C,H,W) image with a constant border (`layout.py:195-207`)."""
    col = _sanitize_color(color)
    c, h, w = image.shape
    out = np.empty((c, h + 2 * border, w + 2 * border), np.float32)
    out[:] = col[:, None, None]
    out[:, border:h + border, border:w + border] = image
    return out


def resize_image(image: np.ndarray, shape: tuple[int, int] | None = None,
                 width: int | None = None,
                 height: int | None = None) -> np.ndarray:
    """Aspect-preserving bilinear resize of a (C,H,W) image
    (`layout.py:210-232`; the reference uses torch antialiased bilinear —
    here cv2 INTER_AREA for downscale / INTER_LINEAR for upscale, the
    equivalent host-side convention)."""
    import cv2

    assert (shape is not None) + (width is not None) + (height is not None) \
        == 1
    _, h, w = image.shape
    if width is not None:
        shape = (int(h * width / w), width)
    elif height is not None:
        shape = (height, int(w * height / h))
    interp = cv2.INTER_AREA if shape[0] < h else cv2.INTER_LINEAR
    hwc = np.transpose(image, (1, 2, 0))
    out = cv2.resize(hwc, (shape[1], shape[0]), interpolation=interp)
    if out.ndim == 2:
        out = out[..., None]
    return np.transpose(out, (2, 0, 1)).astype(np.float32)
