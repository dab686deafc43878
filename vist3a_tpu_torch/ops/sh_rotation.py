"""Real spherical-harmonic rotation (Wigner-D on the real basis).

Port of `vist3a_tpu/ops/sh_rotation.py` (the reference's
`src/misc/sh_rotation.py:10-38`, e3nn's `wigner_D` with a YZX→XYZ basis
change): the block-diagonal real rotation matrices are built from the 3×3
rotation by the Ivanic–Ruedenberg recurrence (J. Phys. Chem. 1996, with
the erratum) — polynomial arithmetic in the rotation's entries, no
trigonometry and no branch on data, any degree, batched.

The degree-1 basis is the renderer's (`kernels/rasterizer.py::eval_sh`,
the Sloan/3DGS signs (−y, z, −x)·C1), so for any direction d and
coefficients c:  eval_sh(rotate_sh(c, R), R·d) == eval_sh(c, d).
"""

from __future__ import annotations

from math import isqrt, sqrt

import torch

__all__ = ["rotate_sh", "sh_rotation_matrices"]


def _kd(a: int, b: int) -> float:
    return 1.0 if a == b else 0.0


def _p(i, a, b, l, d1, dp):
    """Recurrence helper P (Ivanic–Ruedenberg Table 1); i∈{-1,0,1};
    d1/dp are the degree-1 / degree-(l−1) matrices as nested lists of
    batched scalars, centered indexing offset by +1 / +(l−1)."""
    if b == l:
        return (d1[i + 1][2] * dp[a + l - 1][2 * l - 2]
                - d1[i + 1][0] * dp[a + l - 1][0])
    if b == -l:
        return (d1[i + 1][2] * dp[a + l - 1][0]
                + d1[i + 1][0] * dp[a + l - 1][2 * l - 2])
    return d1[i + 1][1] * dp[a + l - 1][b + l - 1]


def _next_band(d1, dp, l):
    """Degree-l real rotation matrix from degree-1 and degree-(l−1)."""
    size = 2 * l + 1
    rows = []
    for m in range(-l, l + 1):
        row = []
        for n in range(-l, l + 1):
            denom = float((l + n) * (l - n)) if abs(n) < l \
                else float(2 * l * (2 * l - 1))
            u = sqrt((l + m) * (l - m) / denom)
            v = 0.5 * sqrt((1 + _kd(m, 0)) * (l + abs(m) - 1)
                           * (l + abs(m)) / denom) * (1 - 2 * _kd(m, 0))
            w = -0.5 * sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) \
                * (1 - _kd(m, 0))
            entry = 0.0
            if u != 0.0:
                entry = entry + u * _p(0, m, n, l, d1, dp)
            if v != 0.0:
                if m == 0:
                    vv = _p(1, 1, n, l, d1, dp) + _p(-1, -1, n, l, d1, dp)
                elif m > 0:
                    vv = _p(1, m - 1, n, l, d1, dp) * sqrt(1 + _kd(m, 1)) \
                        - _p(-1, -m + 1, n, l, d1, dp) * (1 - _kd(m, 1))
                else:
                    vv = _p(1, m + 1, n, l, d1, dp) * (1 - _kd(m, -1)) \
                        + _p(-1, -m - 1, n, l, d1, dp) * sqrt(1 + _kd(m, -1))
                entry = entry + v * vv
            if w != 0.0:
                if m > 0:
                    ww = _p(1, m + 1, n, l, d1, dp) \
                        + _p(-1, -m - 1, n, l, d1, dp)
                else:
                    ww = _p(1, m - 1, n, l, d1, dp) \
                        - _p(-1, -m + 1, n, l, d1, dp)
                entry = entry + w * ww
            row.append(entry)
        assert len(row) == size
        rows.append(row)
    return rows


def _stack(rows) -> torch.Tensor:
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def sh_rotation_matrices(rotations: torch.Tensor, lmax: int) -> list:
    """Per-degree real Wigner matrices for the renderer's SH basis.

    rotations: (..., 3, 3) → list of length lmax+1; entry l has shape
    (..., 2l+1, 2l+1), fp32.  Degree 0 is all-ones (identity 1×1).
    """
    r = rotations.float()
    out = [torch.ones(r.shape[:-2] + (1, 1), dtype=r.dtype, device=r.device)]
    if lmax == 0:
        return out
    # degree 1: D1 = S P R Pᵀ S for the basis (−y, z, −x) (S = diag(−1, 1,
    # −1), P the (y, z, x) permutation), matching eval_sh's degree-1 term
    perm = (1, 2, 0)
    sgn = (-1.0, 1.0, -1.0)
    d1 = [[sgn[i] * sgn[j] * r[..., perm[i], perm[j]] for j in range(3)]
          for i in range(3)]
    out.append(_stack(d1))
    dp = d1
    for l in range(2, lmax + 1):
        dl = _next_band(d1, dp, l)
        out.append(_stack(dl))
        dp = dl
    return out


def rotate_sh(sh_coefficients: torch.Tensor,
              rotations: torch.Tensor) -> torch.Tensor:
    """Rotate real-SH coefficients: coefficients (*#batch, n), rotations
    (*#batch, 3, 3), broadcastable; n = (lmax + 1)².  Satisfies
    eval_sh(rotate_sh(c, R), R·d) == eval_sh(c, d).  Each degree's
    product is summed elementwise in fp32 (no TF32 product on a card)."""
    n = sh_coefficients.shape[-1]
    lmax = isqrt(n) - 1
    if (lmax + 1) ** 2 != n:
        raise ValueError(f"n={n} is not a perfect square")
    mats = sh_rotation_matrices(rotations, lmax)
    pieces = []
    for l, d in enumerate(mats):
        block = sh_coefficients[..., l * l:(l + 1) * (l + 1)]
        pieces.append((d.to(block.dtype) * block[..., None, :]).sum(-1))
    return torch.cat(pieces, dim=-1)
