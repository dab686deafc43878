"""The port's camera trajectories (`vist3a_tpu_torch/viz/trajectories.py`)
against the JAX package's (`vist3a_tpu/viz/trajectories.py`).

Both are host numpy in float64 (float32 out), so every generator is held
bit for bit on random inputs made with numpy from a seed.  The structural
properties that `tests/test_trajectories.py` asserts of the JAX package
(orbit geometry, wobble phase, endpoints and focus of the pivot
interpolation) are asserted of the port too.
"""

import numpy as np
import pytest

import vist3a_tpu.viz.trajectories as jtraj
import vist3a_tpu_torch.viz.trajectories as ttraj
from test_trajectories import _look_at


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,elev,radius", [(12, 20.0, 3.5), (7, -35.0, 1.2),
                                           (60, 0.0, 10.0)])
def test_spin_equals_jax(n, elev, radius):
    _same(ttraj.generate_spin(n, elev, radius),
          jtraj.generate_spin(n, elev, radius))


@pytest.mark.parametrize("scale", [True, False])
def test_wobble_equals_jax(rng, scale):
    radius = rng.uniform(0.1, 1.0, (3,))
    t = np.linspace(0, 1, 9)
    _same(ttraj.generate_wobble_transformation(radius, t, 2, scale),
          jtraj.generate_wobble_transformation(radius, t, 2, scale))
    ext = rng.standard_normal((3, 4, 4)).astype(np.float32)
    _same(ttraj.generate_wobble(ext, radius, t),
          jtraj.generate_wobble(ext, radius, t))


def _random_pose(rng):
    return _look_at(rng.uniform(-3, 3, 3), rng.uniform(-0.5, 0.5, 3),
                    up=rng.uniform(-0.2, 0.2, 3) + np.array([0.0, 1.0, 0.0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolation_equals_jax(seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, 11)
    e0 = np.stack([_random_pose(rng) for _ in range(4)])
    e1 = np.stack([_random_pose(rng) for _ in range(4)])
    e1[1] = e0[1].copy()
    e1[1][:3, 3] += 0.5                        # parallel look rays
    _same(ttraj.interpolate_extrinsics(e0, e1, t),
          jtraj.interpolate_extrinsics(e0, e1, t))
    _same(ttraj.interpolate_extrinsics(e0[0], e1[0], t),
          jtraj.interpolate_extrinsics(e0[0], e1[0], t))
    k0, k1 = rng.uniform(0.3, 1.5, (2, 4, 3, 3))
    _same(ttraj.interpolate_intrinsics(k0, k1, t),
          jtraj.interpolate_intrinsics(k0, k1, t))


def test_spin_orbit_geometry():
    n, elev, radius = 12, 20.0, 3.5
    traj = ttraj.generate_spin(n, elev, radius)
    r = traj[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(r @ np.swapaxes(r, 1, 2),
                               np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(traj[:, :3, 3], axis=-1),
                               radius, rtol=1e-6)
    np.testing.assert_allclose(traj[:, 1, 3], traj[0, 1, 3], atol=1e-6)


def test_wobble_phase():
    radius, t = np.array([0.5]), np.linspace(0, 1, 5)
    tf = ttraj.generate_wobble_transformation(radius, t)
    np.testing.assert_allclose(tf[0, 0], np.eye(4), atol=1e-7)
    np.testing.assert_allclose(tf[0, :, 0, 3],
                               np.sin(2 * np.pi * t) * radius * t, atol=1e-6)


def test_interpolate_extrinsics_endpoints_and_focus():
    focus = np.array([0.2, -0.1, 0.4])
    e0 = _look_at([2.0, 0.5, -2.0], focus)
    e1 = _look_at([-1.5, 0.8, -2.2], focus)
    out = ttraj.interpolate_extrinsics(e0, e1, np.linspace(0, 1, 7))
    np.testing.assert_allclose(out[0], e0.astype(np.float32), atol=1e-4)
    np.testing.assert_allclose(out[-1], e1.astype(np.float32), atol=1e-4)
    for m in out:
        d = focus - m[:3, 3]
        assert float(d / np.linalg.norm(d) @ m[:3, 2]) > 0.999
