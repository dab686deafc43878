"""Host-side image preprocessing (numpy; PIL or OpenCV to decode).

Port of `vist3a_tpu/data/preprocessing.py` (the reference's
`data/image_preprocessing.py` and the stitching datasets' torchvision
transforms): the isotropic half-pixel bilinear resize so min(H, W) equals
the target, then a centre crop to a square; torchvision
`ColorJitter(0.5, 0.5, 0.5, 0.1)` (the four ops in random order, factors
uniform in [max(0, 1 − v), 1 + v], hue in [−0.1, 0.1]); the antialiased
square resize of the feed-forward image; the [0, 1] → [−1, 1] map.  The
arithmetic and the draws from the caller's `np.random.Generator` are the
JAX package's, line for line, so a batch equals its batch bit for bit.

`load_image` decodes with PIL where it imports and with `cv2.imread`
(BGR → RGB) otherwise: a PNG decodes to the same bytes either way.
"""

from __future__ import annotations

import functools

import numpy as np


def load_image(path) -> np.ndarray:
    """RGB image file → float32 (3, H, W) in [0, 1] (ToTensor parity)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
    else:
        import cv2

        bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if bgr is None:
            raise OSError(f"cannot decode {path}")
        rgb = bgr[:, :, ::-1]
    arr = rgb.astype(np.float32) / 255.0
    return arr.transpose(2, 0, 1)


@functools.lru_cache(maxsize=64)
def _halfpixel_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-resize weights, half-pixel convention
    (== torch bilinear align_corners=False)."""
    out = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        w = src - lo
        out[i, lo] += 1.0 - w
        out[i, hi] += w
    return out.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _antialias_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Triangle-filter (bilinear) antialias weights for downscale —
    torchvision Resize(antialias=True) convention."""
    if n_out >= n_in:
        return _halfpixel_matrix(n_in, n_out)
    scale = n_in / n_out
    support = scale  # triangle filter radius scaled by downscale factor
    out = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        idx = np.clip(np.arange(lo, hi + 1), 0, n_in - 1)
        dist = np.abs((np.arange(lo, hi + 1) - center) / scale)
        w = np.clip(1.0 - dist, 0.0, None)
        s = w.sum()
        for j, ww in zip(idx, w / s):
            out[i, j] += ww
    return out.astype(np.float32)


def _resize(images: np.ndarray, size_hw, antialias=False) -> np.ndarray:
    """images: (..., H, W) → (..., h, w).  The JAX package's two batched
    einsums: split into planes, numpy's einsum can sum in another order
    (seen at small sizes), and the batches must be the JAX package's."""
    h_in, w_in = images.shape[-2:]
    h_out, w_out = size_hw
    mk = _antialias_matrix if antialias else _halfpixel_matrix
    mh = mk(h_in, h_out)
    mw = mk(w_in, w_out)
    out = np.einsum("oh,...hw->...ow", mh, images)
    return np.einsum("pw,...ow->...op", mw, out)


def resize_shorter_crop_square_batch(images: np.ndarray,
                                     target_size: int = 448) -> np.ndarray:
    """images: (T, C, H, W) → (T, C, target, target)
    (`image_preprocessing.py:15-53`)."""
    t, c, h0, w0 = images.shape
    scale = target_size / min(h0, w0)
    new_h, new_w = round(h0 * scale), round(w0 * scale)
    images = _resize(images, (new_h, new_w))
    if new_h > target_size:
        y0 = (new_h - target_size) // 2
        images = images[:, :, y0:y0 + target_size, :]
    if new_w > target_size:
        x0 = (new_w - target_size) // 2
        images = images[:, :, :, x0:x0 + target_size]
    return images


def resize_square(images: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize((size, size)) with antialias (feedforward path)."""
    return _resize(images, (size, size), antialias=True)


# --------------------------------------------------------------------------- #
# ColorJitter (torchvision semantics)                                         #
# --------------------------------------------------------------------------- #
_GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def _blend(a, b, f):
    return np.clip(f * a + (1.0 - f) * b, 0.0, 1.0)


def _adjust_brightness(img, f):
    return np.clip(img * f, 0.0, 1.0)


def _adjust_contrast(img, f):
    # torchvision: blend toward the PER-IMAGE mean of the grayscale
    gray = np.tensordot(_GRAY, img, axes=((0,), (-3,)))      # (..., H, W)
    mean = gray.mean(axis=(-2, -1), keepdims=True)[..., None, :, :]
    return _blend(img, mean, f)


def _adjust_saturation(img, f):
    gray = np.tensordot(_GRAY, img, axes=((0,), (-3,)))
    return _blend(img, gray[..., None, :, :], f)


def _adjust_hue(img, f):
    """Shift hue by f ∈ [−0.5, 0.5] via HSV round-trip (torchvision math)."""
    r, g, b = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    cr = maxc - minc
    s = np.where(maxc > 0, cr / np.maximum(maxc, 1e-12), 0.0)
    cr_safe = np.where(cr > 0, cr, 1.0)
    rc = (maxc - r) / cr_safe
    gc = (maxc - g) / cr_safe
    bc = (maxc - b) / cr_safe
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(cr > 0, h, 0.0)

    h = (h + f) % 1.0
    i = np.floor(h * 6.0)
    fr = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-3)


def color_jitter(rng: np.random.Generator, images: np.ndarray,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.1) -> np.ndarray:
    """Random-order jitter, one factor draw shared by the clip (the
    reference jitters the stacked (T,C,H,W) tensor in one call)."""
    ops = []
    fb = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    ops.append(lambda x: _adjust_brightness(x, fb))
    fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    ops.append(lambda x: _adjust_contrast(x, fc))
    fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    ops.append(lambda x: _adjust_saturation(x, fs))
    fh = rng.uniform(-hue, hue)
    ops.append(lambda x: _adjust_hue(x, fh))
    for i in rng.permutation(4):
        images = ops[i](images)
    return images.astype(np.float32)


def to_pm1(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) * 2.0 - 1.0
