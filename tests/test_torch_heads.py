"""The port's heads, geometry and Gaussian adapter against the JAX package.

Weights come from the JAX package's `init` functions and are carried over
by `convert.from_jax_params`; inputs are made with numpy from a seed.  Both
sides run fp32 on the CPU.  Tolerances: 1e-4 relative to each output's
largest magnitude for the DPT cascades (some twenty convolutions and two
resizes deep, each summing in another order), 1e-5 for the single
operations and the closed-form geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.nn import gaussians as jg
from vist3a_tpu.nn import geometry as jgeo
from vist3a_tpu.nn import heads as jh
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import gaussians as tg
from vist3a_tpu_torch.nn import geometry as tgeo
from vist3a_tpu_torch.nn import heads as th

ATOL = 1e-5
CASCADE_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _load(module, tree):
    sd = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    module.load_state_dict(sd, strict=True)
    return module


def _close_to_range(got, want, rtol=CASCADE_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("k,ci,co,stride,pad", [
    (3, 5, 7, 1, 1), (7, 3, 8, 1, 3), (3, 6, 4, 2, 1), (1, 9, 3, 1, 0),
    (3, 512, 8, 1, 1),          # the im2col-matmul form of the JAX package
])
def test_conv2d_kernel_mat_layout(rng, k, ci, co, stride, pad):
    """`kernel_mat<k>` (k·k·ci, co), row-major over (kh, kw, ci) → OIHW."""
    p = jh.conv2d_init(jax.random.key(0), ci, co, k)
    x = rng.standard_normal((2, 9, 10, ci)).astype(np.float32)
    want = jh.conv2d(p, jnp.asarray(x), stride=stride, padding=pad,
                     channels_last=True)
    conv = _load(th.Conv2d(ci, co, k, stride=stride, padding=pad), p)
    got = conv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose2d_layout(rng, k):
    """`kernel_hwio` (kh, kw, c_out, c_in) with transpose_kernel=True →
    ConvTranspose2d (c_in, c_out, kh, kw): a random (not symmetric) kernel
    shows both the spatial flip and the in/out swap."""
    p = jh.conv_transpose2d_init(jax.random.key(1), 6, 5, k)
    x = rng.standard_normal((2, 4, 3, 6)).astype(np.float32)
    want = jh.conv_transpose2d(p, jnp.asarray(x), stride=k,
                               channels_last=True)
    conv = _load(th.ConvTranspose2d(6, 5, k, stride=k), p)
    got = conv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(4, 8), (7, 3), (1, 5), (32, 448)])
def test_resize_bilinear_align_corners(rng, n_in, n_out):
    np.testing.assert_array_equal(th._interp_matrix(n_in, n_out),
                                  jh._interp_matrix(n_in, n_out))
    x = rng.standard_normal((2, 3, n_in, n_in + 1)).astype(np.float32)
    size = (n_out, n_out + 2)
    want = jh.resize_bilinear_align_corners(jnp.asarray(x), size)
    got = th.resize_bilinear_align_corners(_t(x), size)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    # and torch's own align-corners semantics; it rounds each source
    # coordinate in fp32, which reaches ~1e-5 at 448 outputs
    ref = torch.nn.functional.interpolate(_t(x), size=size, mode="bilinear",
                                          align_corners=True)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=0)


def test_uv_pos_embed(rng):
    x = rng.standard_normal((2, 16, 6, 9)).astype(np.float32)
    want = jh.apply_uv_pos_embed(jnp.asarray(x), 126, 84)
    got = th.apply_uv_pos_embed(_t(x), 126, 84)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


# small heads at the tiny stitched config's widths: 2C = 64, 56² images
DIM_IN, IMG, PSI, B, S = 64, 56, 5, 1, 3
P = (IMG // 14) ** 2 + PSI


def _head_cfgs(mod, gs: bool):
    kw = dict(dim_in=DIM_IN, features=16, out_channels=(8, 16, 16, 16),
              frames_chunk_size=2)          # S = 3 → chunks of 2 and 1
    if gs:
        return mod.GSHeadConfig(output_dim=84, head2_features=16,
                                pos_embed=False, **kw)
    return mod.DPTConfig(head2_features=8, **kw)


def _taps(rng):
    return [rng.standard_normal((B, S, P, DIM_IN)).astype(np.float32)
            for _ in range(4)]


def test_dpt_depth_head(rng):
    cfg_j, cfg_t = _head_cfgs(jh, False), _head_cfgs(th, False)
    params = jh.dpt_init(jax.random.key(2), cfg_j)
    taps = _taps(rng)
    want = jh.dpt_apply(params, [jnp.asarray(t) for t in taps], (IMG, IMG),
                        PSI, cfg_j, (B, S))
    head = _load(th.DPTHead(cfg_t), params)
    got = th.dpt_apply(head, [_t(t) for t in taps], (IMG, IMG), PSI, cfg_t,
                       (B, S))
    for g, w in zip(got, want):
        _close_to_range(g, w)


def test_gs_head_with_rgb_merger(rng):
    cfg_j, cfg_t = _head_cfgs(jh, True), _head_cfgs(th, True)
    params = jh.gs_head_init(jax.random.key(3), cfg_j)
    taps = _taps(rng)
    images = rng.random((B, S, 3, IMG, IMG)).astype(np.float32)
    want = jh.gs_head_apply(params, [jnp.asarray(t) for t in taps],
                            jnp.asarray(images), PSI, cfg_j)
    head = _load(th.GSHead(cfg_t), params)
    got = th.gs_head_apply(head, [_t(t) for t in taps], _t(images), PSI,
                           cfg_t)
    assert tuple(got.shape) == (B, S, IMG, IMG, 84)
    _close_to_range(got, want)


def test_camera_head_four_iterations(rng):
    """fp32 throughout, plain attention over the S camera tokens; every
    refinement's activated pose encoding is compared."""
    cfg_j = jh.CameraHeadConfig(dim_in=DIM_IN, trunk_depth=2, num_heads=2)
    cfg_t = th.CameraHeadConfig(dim_in=DIM_IN, trunk_depth=2, num_heads=2)
    params = jh.camera_head_init(jax.random.key(4), cfg_j)
    params["empty_pose_tokens"] = jnp.asarray(
        rng.standard_normal((1, 1, 9)), jnp.float32)
    tap = rng.standard_normal((B, S, P, DIM_IN)).astype(np.float32)
    want = jh.camera_head_apply(params, jnp.asarray(tap), cfg_j)
    head = _load(th.CameraHead(cfg_t), params)
    got = th.camera_head_apply(head, _t(tap), cfg_t)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close_to_range(g, w)


def test_geometry(rng):
    q = rng.standard_normal((2, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(tgeo.quat_to_mat(_t(q))),
                               _np(jgeo.quat_to_mat(jnp.asarray(q))),
                               atol=ATOL, rtol=0)
    enc = np.concatenate([rng.standard_normal((2, 3, 7)),
                          rng.uniform(0.5, 1.5, (2, 3, 2))], -1
                         ).astype(np.float32)
    ej, kj = jgeo.pose_encoding_to_extri_intri(jnp.asarray(enc), (42, 56))
    et, kt = tgeo.pose_encoding_to_extri_intri(_t(enc), (42, 56))
    np.testing.assert_allclose(_np(et), _np(ej), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(kt), _np(kj), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(_np(tgeo.closed_form_inverse_se3(et)),
                               _np(jgeo.closed_form_inverse_se3(ej)),
                               atol=ATOL, rtol=1e-6)
    depth = rng.uniform(0.5, 3.0, (2, 3, 42, 56, 1)).astype(np.float32)
    want = jgeo.unproject_depth(jnp.asarray(depth), ej, kj)
    got = tgeo.unproject_depth(_t(depth), et, kt)
    _close_to_range(got, want, rtol=ATOL)


def test_gaussian_adapter(rng):
    raw = rng.standard_normal((2, 50, 82)).astype(np.float32)
    means = rng.standard_normal((2, 50, 3)).astype(np.float32)
    pdf = rng.random((2, 50)).astype(np.float32)
    np.testing.assert_allclose(_np(tg.map_pdf_to_opacity(_t(pdf))),
                               _np(jg.map_pdf_to_opacity(jnp.asarray(pdf))),
                               atol=ATOL, rtol=0)
    want = jg.unified_gaussian_adapter(jnp.asarray(means), jnp.asarray(pdf),
                                       jnp.asarray(raw), 4)
    got = tg.unified_gaussian_adapter(_t(means), _t(pdf), _t(raw), 4)
    for name in jg.Gaussians._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), atol=ATOL,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        _np(tg.covariance_entries(got.scales, got.rotations)),
        _np(jg.covariance_entries(want.scales, want.rotations)), atol=ATOL,
        rtol=1e-5)
