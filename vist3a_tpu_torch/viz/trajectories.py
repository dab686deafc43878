"""Camera trajectories for rendered fly-throughs.

Port of `vist3a_tpu/viz/trajectories.py` (the reference's
`src/visualization/camera_trajectory/`), host numpy in float64 and equal to
the JAX package's bit for bit:

  * `generate_spin` — an orbit at fixed elevation and radius (`spin.py`);
  * `generate_wobble` / `generate_wobble_transformation` — a circular sway
    in the image plane (`wobble.py`);
  * `interpolate_extrinsics` / `interpolate_intrinsics` — pose
    interpolation about the least-squares intersection of the two look rays
    (`interpolation.py`).

Rotations are written out (Rodrigues, intrinsic Y-X-Z Euler), without
scipy.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "generate_spin",
    "generate_wobble",
    "generate_wobble_transformation",
    "interpolate_extrinsics",
    "interpolate_intrinsics",
]


# --------------------------------------------------------------------------- #
# small rotation helpers                                                      #
# --------------------------------------------------------------------------- #
def _rotvec_to_matrix(rv: np.ndarray) -> np.ndarray:
    """Rodrigues formula, batched over leading dims."""
    rv = np.asarray(rv, dtype=np.float64)
    theta = np.linalg.norm(rv, axis=-1, keepdims=True)
    safe = np.where(theta > 1e-12, theta, 1.0)
    axis = rv / safe
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    k = np.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                 axis=-1).reshape(*x.shape, 3, 3)
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + s * k + (1.0 - c) * (k @ k)


def _euler_yxz_to_matrix(angles: np.ndarray) -> np.ndarray:
    """Intrinsic Y-X-Z Euler → matrix (R = Ry(a0) Rx(a1) Rz(a2)); matches
    scipy's `R.from_euler("YXZ", ...)` used at `interpolation.py:100-108`."""
    a = np.asarray(angles, dtype=np.float64)
    ay, ax, az = a[..., 0], a[..., 1], a[..., 2]

    def rot(axis, ang):
        c, s = np.cos(ang), np.sin(ang)
        one, zero = np.ones_like(ang), np.zeros_like(ang)
        rows = {
            "x": [one, zero, zero, zero, c, -s, zero, s, c],
            "y": [c, zero, s, zero, one, zero, -s, zero, c],
            "z": [c, -s, zero, s, c, zero, zero, zero, one],
        }[axis]
        return np.stack(rows, axis=-1).reshape(*ang.shape, 3, 3)

    return rot("y", ay) @ rot("x", ax) @ rot("z", az)


def _matrix_to_euler_yxz(m: np.ndarray) -> np.ndarray:
    """Inverse of `_euler_yxz_to_matrix` (gimbal-safe enough for the pivot
    parametrization's in-plane matrices)."""
    m = np.asarray(m, dtype=np.float64)
    x = np.arcsin(np.clip(-m[..., 1, 2], -1.0, 1.0))
    y = np.arctan2(m[..., 0, 2], m[..., 2, 2])
    z = np.arctan2(m[..., 1, 0], m[..., 1, 1])
    return np.stack([y, x, z], axis=-1)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# --------------------------------------------------------------------------- #
# spin                                                                        #
# --------------------------------------------------------------------------- #
def generate_spin(num_frames: int, elevation: float,
                  radius: float) -> np.ndarray:
    """Orbit trajectory (`spin.py:9-37`): azimuth sweep × elevation tilt ×
    pull-back along look; returns (num_frames, 4, 4) float32."""
    tf_translation = np.eye(4, dtype=np.float64)
    tf_translation[:2] *= -1
    tf_translation[2, 3] = -radius

    phi = 2.0 * np.pi * (np.arange(num_frames) / num_frames)
    rotvecs = np.stack([np.zeros_like(phi), phi, np.zeros_like(phi)],
                       axis=-1)
    tf_azimuth = np.broadcast_to(np.eye(4), (num_frames, 4, 4)).copy()
    tf_azimuth[:, :3, :3] = _rotvec_to_matrix(rotvecs)

    tf_elevation = np.eye(4, dtype=np.float64)
    tf_elevation[:3, :3] = _rotvec_to_matrix(
        np.array([np.deg2rad(elevation), 0.0, 0.0]))

    return (tf_azimuth @ tf_elevation @ tf_translation).astype(np.float32)


# --------------------------------------------------------------------------- #
# wobble                                                                      #
# --------------------------------------------------------------------------- #
def generate_wobble_transformation(radius: np.ndarray, t: np.ndarray,
                                   num_rotations: int = 1,
                                   scale_radius_with_t: bool = True
                                   ) -> np.ndarray:
    """(⋯batch,) radius × (T,) t → (⋯batch, T, 4, 4) image-plane circular
    translation (`wobble.py:8-24`)."""
    radius = np.asarray(radius, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    tf = np.broadcast_to(np.eye(4),
                         (*radius.shape, t.shape[0], 4, 4)).copy()
    radius = radius[..., None]
    if scale_radius_with_t:
        radius = radius * t
    tf[..., 0, 3] = np.sin(2.0 * np.pi * num_rotations * t) * radius
    tf[..., 1, 3] = -np.cos(2.0 * np.pi * num_rotations * t) * radius
    return tf.astype(np.float32)


def generate_wobble(extrinsics: np.ndarray, radius: np.ndarray,
                    t: np.ndarray) -> np.ndarray:
    """Apply the wobble in each camera's frame (`wobble.py:27-31`)."""
    tf = generate_wobble_transformation(radius, t)
    return (np.asarray(extrinsics, dtype=np.float32)[..., None, :, :]
            @ tf)


# --------------------------------------------------------------------------- #
# pivot interpolation                                                         #
# --------------------------------------------------------------------------- #
def interpolate_intrinsics(initial: np.ndarray, final: np.ndarray,
                           t: np.ndarray) -> np.ndarray:
    """Linear intrinsics interpolation (`interpolation.py:9-17`)."""
    initial = np.asarray(initial, dtype=np.float64)[..., None, :, :]
    final = np.asarray(final, dtype=np.float64)[..., None, :, :]
    t = np.asarray(t, dtype=np.float64)[:, None, None]
    return (initial + (final - initial) * t).astype(np.float32)


def _intersect_rays(a_o, a_d, b_o, b_d):
    """Least-squares intersection of two ray sets (`interpolation.py:20-46`)."""
    origins = np.stack([a_o, b_o], axis=-2)
    directions = np.stack([a_d, b_d], axis=-2)
    n = directions[..., :, None] * directions[..., None, :] - np.eye(3)
    lhs = n.sum(axis=-3)
    rhs = (n @ origins[..., :, None])[..., 0].sum(axis=-2)
    # callers exclude parallel rays, so lhs is invertible
    return np.linalg.solve(lhs, rhs[..., None])[..., 0]


def _coordinate_frame(y, z):
    """Frame from perpendicular unit Y/Z (`interpolation.py:57-63`)."""
    y, z = np.broadcast_arrays(y, z)
    return np.stack([np.cross(y, z), y, z], axis=-1)


def _rotation_coordinate_frame(a, b, eps=1e-4):
    """Frame whose Y is normal to span(a, b) (`interpolation.py:66-85`)."""
    b = np.array(b, dtype=np.float64, copy=True)
    for fallback in ([0.0, 0.0, 1.0], [0.0, 1.0, 0.0]):
        parallel = np.abs(np.abs((a * b).sum(-1)) - 1.0) < eps
        b[parallel] = fallback
    return _coordinate_frame(_normalize(np.cross(a, b)), a)


def _extrinsics_to_pivot(extrinsics, pivot_frame, pivot_point):
    """4×4 → 5-DoF pivot parameters (`interpolation.py:111-137`)."""
    pivot_axis = pivot_frame[..., :, 1]
    translation_frame = _coordinate_frame(pivot_axis, extrinsics[..., :3, 2])
    delta = pivot_point - extrinsics[..., :3, 3]
    translation = (translation_frame * delta[..., :, None]).sum(-2)
    inverted = np.swapaxes(pivot_frame, -1, -2) @ extrinsics[..., :3, :3]
    euler = _matrix_to_euler_yxz(inverted)
    return np.concatenate([translation, euler[..., 0:1], euler[..., 2:3]],
                          axis=-1)


def _pivot_to_extrinsics(params, pivot_frame, pivot_point):
    """5-DoF pivot parameters → 4×4 (`interpolation.py:140-166`)."""
    translation, y, z = params[..., :3], params[..., 3:4], params[..., 4:5]
    euler = np.concatenate([y, np.zeros_like(y), z], axis=-1)
    rotation = pivot_frame @ _euler_yxz_to_matrix(euler)
    pivot_axis = pivot_frame[..., :, 1]
    translation_frame = _coordinate_frame(pivot_axis, rotation[..., :3, 2])
    delta = (translation_frame * translation[..., None, :]).sum(-1)
    origin = pivot_point - delta
    out = np.broadcast_to(np.eye(4), (*origin.shape[:-1], 4, 4)).copy()
    out[..., :3, :3] = rotation
    out[..., :3, 3] = origin
    return out


def _interpolate_circular(a, b, t):
    """Shortest-path angular lerp (`interpolation.py:169-196`)."""
    tau = 2.0 * np.pi
    a, b, t = np.broadcast_arrays(a % tau, b % tau, t)
    d = np.abs(b - a)
    d_left = np.abs(b - (a - tau))
    d_right = np.abs(b - (a + tau))
    use_left = (d_left < d_right) & ~((d < d_left) & (d < d_right))
    use_right = ~((d < d_left) & (d < d_right)) & ~use_left
    result = a + (b - a) * t
    result = np.where(use_left, (a - tau) + (b - (a - tau)) * t, result)
    result = np.where(use_right, (a + tau) + (b - (a + tau)) * t, result)
    return result


def interpolate_extrinsics(initial: np.ndarray, final: np.ndarray,
                           t: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Pose interpolation rotating about the two look rays' least-squares
    intersection (`interpolation.py:222-247`); (…batch, T, 4, 4) float32."""
    initial = np.asarray(initial, dtype=np.float64)
    final = np.asarray(final, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    squeeze = initial.ndim == 2
    if squeeze:
        initial, final = initial[None], final[None]

    init_look, final_look = initial[..., :3, 2], final[..., :3, 2]
    dot = (init_look * final_look).sum(-1)
    parallel = np.abs(np.abs(dot) - 1.0) < eps
    init_o, final_o = initial[..., :3, 3], final[..., :3, 3]
    pivot_point = 0.5 * (init_o + final_o)
    if (~parallel).any():
        pivot_point[~parallel] = _intersect_rays(
            init_o[~parallel], init_look[~parallel],
            final_o[~parallel], final_look[~parallel])

    pivot_frame = _rotation_coordinate_frame(init_look, final_look, eps=eps)
    p0 = _extrinsics_to_pivot(initial, pivot_frame, pivot_point)
    p1 = _extrinsics_to_pivot(final, pivot_frame, pivot_point)

    # interpolate: translation lerp, angles circular (`interpolation.py:
    # 199-219`; t enters as (T, 1) against (..., 1, d) parameters)
    p0e, p1e = p0[..., None, :], p1[..., None, :]
    te = t[:, None]
    t_lerp = p0e[..., :3] + (p1e[..., :3] - p0e[..., :3]) * te
    r_lerp = _interpolate_circular(p0e[..., 3:], p1e[..., 3:], te)
    params = np.concatenate([t_lerp, r_lerp], axis=-1)

    out = _pivot_to_extrinsics(params, pivot_frame[..., None, :, :],
                               pivot_point[..., None, :])
    if squeeze:
        out = out[0]
    return out.astype(np.float32)
