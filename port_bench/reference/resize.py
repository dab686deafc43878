"""The plain reference's `jax.image.resize` weights for bicubic and bilinear
(frozen from the port's `ops/resize.py`; see `reference/scene.py`; it
imports nothing of the port), used to interpolate the ViT's positional
embedding.

Each axis whose size changes is resized by a dense (n_in, n_out) weight
matrix: sample j of n_out sits at (j + 0.5)·n_in/n_out − 0.5 in input
pixels, a tap at input pixel i weighs kernel(|sample − i| / s), with
s = max(n_in/n_out, 1) when antialiasing and 1 otherwise, and each output
sample's weights are divided by their sum (zero where the sum is below
1000·eps32).  The kernels are Keys' cubic with a = −0.5 ("bicubic") and the
triangle ("bilinear"), built in fp32.
"""

from __future__ import annotations

import functools

import numpy as np


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int, method: str = "bicubic",
                  antialias: bool = True) -> np.ndarray:
    """(n_out, n_in) float32 weights of `jax.image.resize(..., method,
    antialias)` along one axis (scale n_out/n_in, no translation), in fp32
    as XLA's CPU code computes them: the sample position as one fused
    multiply-add ((j + 0.5)·(1/scale) − 0.5, rounded once; an fp32 multiply
    then subtract moves it by up to half an ulp, ~4e-6 at 100 pixels, and a
    weight with it) and the division by the kernel's scale as a multiply by
    its fp32 reciprocal."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    j = np.arange(n_out, dtype=np.float64) + 0.5
    sample = (j * np.float64(inv_scale) - 0.5).astype(f32)     # the FMA
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        * f32(1.0 / float(kernel_scale))
    w = KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    return np.ascontiguousarray(w.T).astype(f32)


