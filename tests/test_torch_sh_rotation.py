"""SH rotation (`ops/sh_rotation.py`) and voxel fusion
(`ops/voxel_fusion.py`) of the port against the JAX package's, on the CPU.

  * `rotate_sh` and `sh_rotation_matrices` against JAX's at degrees 0-4,
    batched: within 1e-5 of the coefficients' largest magnitude (the same
    polynomial recurrence, summed in each library's order);
  * the defining property on the renderer's own basis:
    eval_sh(rotate_sh(c, R), R·d) = eval_sh(c, d), with the port's
    `kernels/rasterizer.py::eval_sh` (2e-4 relative, 2e-5 absolute, the
    JAX test's limits);
  * voxel fusion against JAX's (rows in the same lexicographic key order,
    the same valid count; points and features within 1e-5) and against the
    naive per-voxel softmax grouping of `tests/test_gen_eval.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sh_rotation import _random_rotation
from vist3a_tpu.ops import sh_rotation as jsh
from vist3a_tpu.ops import voxel_fusion as jvf
from vist3a_tpu_torch.kernels.rasterizer import eval_sh
from vist3a_tpu_torch.ops import sh_rotation as tsh
from vist3a_tpu_torch.ops import voxel_fusion as tvf

ROT_ATOL = 1e-5


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_rotate_sh_matches_jax(degree):
    rng = np.random.default_rng(10 + degree)
    n = (degree + 1) ** 2
    c = rng.standard_normal((5, 3, n)).astype(np.float32)
    rots = np.stack([_random_rotation(rng) for _ in range(5)]).astype(
        np.float32)[:, None]                                  # (5, 1, 3, 3)
    want = np.asarray(jsh.rotate_sh(jnp.asarray(c), jnp.asarray(rots)))
    got = tsh.rotate_sh(torch.from_numpy(c), torch.from_numpy(rots)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ROT_ATOL * np.abs(c).max())
    mats_j = jsh.sh_rotation_matrices(jnp.asarray(rots[:, 0]), degree)
    mats_t = tsh.sh_rotation_matrices(torch.from_numpy(rots[:, 0]), degree)
    for a, b in zip(mats_t, mats_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ROT_ATOL)


@pytest.mark.parametrize("degree", [1, 2, 4])
def test_appearance_is_kept_under_rotation(degree):
    rng = np.random.default_rng(degree)
    n = (degree + 1) ** 2
    c = rng.standard_normal((3, n)).astype(np.float32) * 0.2
    c[:, 0] += 5.0                       # away from eval_sh's clamp
    rot = torch.from_numpy(_random_rotation(rng).astype(np.float32))
    dirs = rng.standard_normal((64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = torch.from_numpy(dirs)
    c = torch.from_numpy(c)
    before = eval_sh(c[None], dirs, degree)
    after = eval_sh(tsh.rotate_sh(c, rot)[None], dirs @ rot.T, degree)
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_voxel_fusion_matches_jax_and_naive(rng):
    n, c, vs = 64, 5, 0.4
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    feat = rng.standard_normal((n, c)).astype(np.float32)
    conf = rng.standard_normal((n,)).astype(np.float32)
    jp, jf, jv = map(np.asarray, jvf.voxelize_with_fusion(
        jnp.asarray(feat), jnp.asarray(pts), vs, jnp.asarray(conf)))
    tp, tf, tv = (x.numpy() for x in tvf.voxelize_with_fusion(
        torch.from_numpy(feat), torch.from_numpy(pts), vs,
        torch.from_numpy(conf)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tp[tv], jp[jv], atol=1e-5)
    np.testing.assert_allclose(tf[tv], jf[jv], atol=1e-5)
    assert not tp[~tv].any() and not tf[~tv].any()

    # naive: group by voxel key in sorted order, per-voxel softmax mean
    keys = np.round(pts / vs).astype(np.int32)
    uniq = sorted({tuple(k) for k in keys})
    assert tv.sum() == len(uniq)
    for row, u in enumerate(uniq):
        sel = (keys == np.asarray(u)).all(-1)
        w = np.exp(conf[sel] - conf[sel].max())
        w = w / (w.sum() + 1e-6)
        np.testing.assert_allclose(tp[row], (pts[sel] * w[:, None]).sum(0),
                                   atol=1e-5)
        np.testing.assert_allclose(tf[row], (feat[sel] * w[:, None]).sum(0),
                                   atol=1e-5)
