"""Orbit frames on which the export's uint8 conversion is easiest to get
wrong, made with numpy from a seed.  numpy only, so that the card tests
(`test_torch_gpu.py`, which import neither JAX nor the JAX package) and
the CPU tests (`test_torch_export.py`) share them.

`orbit(case, shape, seed)` → colour (N, 3, H, W) and depth (N, H, W)
float32, each case's depth:

  * `random`: uniform over [0.5, 4), 0.5 % of the pixels 0 (empty);
  * `nonfinite`: `random` with ±inf pixels in every frame and NaN pixels
    outside the key frames of 13 views (with 1 view every frame is a key,
    so the quantiles and every pixel are NaN);
  * `bin_edges`: 5 % of each frame's pixels at `LO` and 5 % at `HI`, so the
    1 % and 99 % quantiles are exactly those whatever the key frames; the
    rest at `LO + k·(HI − LO)/256` for k = −1…257 (exactly turbo's bin
    edge k; k = 256 is exactly 1.0 after normalisation) and up to 8
    float32 steps either side, shuffled, the same few below `LO` and above
    `HI` as fall in the first and last bins;
  * `outlier`: `random` with one pixel far above the 99 % quantile and one
    below 0;
  * `constant`: 2.0 everywhere (quantiles equal, the 1e-12 branch) but two
    pixels outside the key frames of 13 views.

The colour frames hold uniform values over [−0.2, 1.2) and, in a quarter
of the pixels, k/255 (k = 0…255) and up to 4 float32 steps either side,
where ×255 lands on the edge of a uint8 step.
"""

import numpy as np

CASES = ("random", "nonfinite", "bin_edges", "outlier", "constant")
# the bin_edges case's quantiles: a range of 3, which no power of two
# divides, so a division by it and a multiply by its reciprocal differ
# next to some edges; from 0, so that a depth a float32 step from an edge
# is a normalised depth about a step from its edge
LO, HI = 0.0, 3.0


def _steps(values, steps: int) -> np.ndarray:
    """Each positive float32 value and its neighbours up to `steps` float32
    steps either side (0 and values below `steps` steps keep only their
    positive neighbours)."""
    bits = np.asarray(values, np.float32).view(np.int32)[:, None] \
        + np.arange(-steps, steps + 1, dtype=np.int32)
    return bits[bits >= 0].view(np.float32)


def orbit(case: str, shape, seed: int):
    rng = np.random.default_rng(seed)
    n, h, w = shape
    color = rng.uniform(-0.2, 1.2, (n, 3, h, w)).astype(np.float32)
    flat = color.reshape(-1)
    edges = np.concatenate([[0.0], _steps(np.arange(1, 256) / 255, 4)])
    at = rng.random(flat.size) < 0.25
    flat[at] = np.resize(edges, int(at.sum()))

    depth = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    depth[rng.random(shape) < 0.005] = 0.0
    if case == "nonfinite":
        for value, share in ((np.inf, 0.002), (-np.inf, 0.002)):
            depth[rng.random(shape) < share] = value
        off_key = np.flatnonzero(np.arange(n) % 13 != 0)
        depth[off_key[::2], ::3, ::5] = np.nan
    elif case == "bin_edges":
        order = rng.permuted(np.tile(np.arange(h * w), (n, 1)), axis=1)
        m = h * w // 20
        frames = np.arange(n)[:, None]
        depth = depth.reshape(n, -1)
        depth[frames, order[:, :m]] = LO
        depth[frames, order[:, m:2 * m]] = HI
        rest = (frames, order[:, 2 * m:])
        k = np.arange(-1, 258)
        values = rng.permutation(_steps(LO + k * (HI - LO) / 256, 8))
        depth[rest] = np.resize(values, order[:, 2 * m:].shape)
        depth = depth.reshape(shape)
    elif case == "outlier":
        depth[3, 2, 2] = 40.0
        depth[5, 1, 3] = -3.0
    elif case == "constant":
        depth[:] = 2.0
        depth[1, 0, 0] = 3.0
        depth[2, 0, 0] = 1.0
    elif case != "random":
        raise ValueError(f"unknown case {case!r}")
    return color, depth
