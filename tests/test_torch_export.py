"""The decode-and-export slice of the port against the JAX package.

`decode_and_reconstruct` at the tiny `T23DConfig` of
`tests/test_t23d_pipeline.py` (64² video of 13 frames from a (1, 16, 4, 8, 8)
latent, tiny stitched decoder, 56² feed-forward images, 40,768 Gaussians),
with weights from the JAX `init` carried over by `convert`; then the
export: camera interpolation, turbo colouring and the PLY file, which must
equal the JAX package's exactly, and the orbit render.

Tolerances, with their reasons:
  * VAE video and feed-forward image: the VAE decodes in bf16 on both sides
    (test_torch_vae.py: max 2⁻³, mean 2⁻⁶ between the two bf16 videos);
  * what depends on the latent alone (means, depth, cameras): relative 1e-3
    of each output's range, as the fp32 slice test;
  * what also reads the bf16 image through the GS head's RGB merger
    (covariances, harmonics, opacities): relative 2⁻⁴ (observed 3e-3,
    1.4e-2, 5.6e-4); opacities where the two confidence masks agree, and
    those agree on all but 0.1 % of the pixels (observed 2 of 40,768: the
    10 % quantile moves a pixel across it);
  * the orbit render of the same Gaussians: atol 2e-5 (colour, alpha) and
    2e-4 (depth) on all but 0.5 % of the pixels, where the 1e-4 stop may
    fire one pair apart (log-space T in the TPU kernel, products here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import CAMERA_BIAS, _configs
from test_torch_vae import TCFG as TVAE_CFG
from test_torch_vae import decoder_params
from vist3a_tpu.io import ply_export as jply
from vist3a_tpu.io import video_export as jvid
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import splat_decoder as jsd
from vist3a_tpu.nn import wan_vae as jvae
from vist3a_tpu.pipelines import t23d as jt
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.io import ply_export as tply
from vist3a_tpu_torch.io import turbo as tturbo
from vist3a_tpu_torch.io import video_export as tvid
from vist3a_tpu_torch.kernels import rasterizer as tr
from vist3a_tpu_torch.nn import splat_decoder as tsd
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.nn.gaussians import Gaussians as TGaussians
from vist3a_tpu_torch.pipelines import t23d as tt
from vist3a_tpu_torch.stitch import chopped_anysplat as tca


def _tiny_configs():
    jst, tst = _configs()
    jvc = jvae.WanVAEConfig(base_dim=8, z_dim=16, num_res_blocks=1)
    jcfg = jt.T23DConfig(width=64, height=64, num_frames=13, vae=jvc,
                         stitched=jst, feedforward_size=56)
    tcfg = tt.T23DConfig(width=64, height=64, num_frames=13, vae=TVAE_CFG,
                         stitched=tst, feedforward_size=56)
    return jcfg, tcfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain composite runs thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads oversubscribe the cores and
    slow them fifty-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def decoded():
    """(port outputs, JAX outputs, JAX params) of one seeded latent."""
    jcfg, tcfg = _tiny_configs()
    params = {
        "encoder": jax.jit(lambda k: jenc.init(k, jcfg.stitched.encoder))(
            jax.random.key(0)),
        "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg.stitched),
        "vae": jax.jit(decoder_params)(jax.random.key(2))}
    params["encoder"]["camera_head"]["pose_branch"]["fc2"]["b"] = \
        jnp.asarray(CAMERA_BIAS)
    params = jax.tree_util.tree_map(np.asarray, params)
    assert jcfg.latent_shape == tcfg.latent_shape == (1, 16, 4, 8, 8)
    z = np.random.default_rng(0).standard_normal(jcfg.latent_shape) \
        .astype(np.float32)
    want = jax.jit(lambda p, z: jt.decode_and_reconstruct(p, z, jcfg))(
        params, jnp.asarray(z))

    vae = convert.load_jax_vae_params(tvae.WanVAEDecoder(tcfg.vae),
                                      params["vae"]).eval()
    stitched = convert.load_jax_params(
        tca.StitchedDecoder(tcfg.stitched),
        {k: params[k] for k in ("encoder", "stitch_conv")}).eval()
    got = tt.decode_and_reconstruct(vae, stitched, torch.from_numpy(z), tcfg,
                                    device="cpu")
    return got, want, params


def _rel(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_decode_and_reconstruct_video_matches_jax(decoded):
    (out, video), (_, want_video), _ = decoded
    assert video.dtype == torch.float32
    assert tuple(video.shape) == (1, 3, 13, 64, 64)
    assert float(video.abs().max()) <= 1.0
    d = np.abs(video.numpy() - np.asarray(want_video))
    assert d.max() <= 2 ** -3 and d.mean() <= 2 ** -6


@pytest.mark.parametrize("name,tol", [
    ("means", 1e-3), ("depth", 1e-3), ("extrinsic_c2w", 1e-3),
    ("intrinsic_norm", 1e-3), ("covariances", 2 ** -4),
    ("harmonics", 2 ** -4), ("opacities", 2 ** -4)])
def test_decode_and_reconstruct_matches_jax(decoded, name, tol):
    (out, _), (want, _), _ = decoded
    g, wg = out.gaussians, want.gaussians
    agree = torch.from_numpy(np.asarray(want.conf_valid_mask)) \
        == out.conf_valid_mask
    assert agree.float().mean() >= 0.999
    keep = agree.reshape(1, -1)
    fields = {"means": (g.means, wg.means),
              "covariances": (g.covariances, wg.covariances),
              "harmonics": (g.harmonics, wg.harmonics),
              "opacities": (g.opacities[keep],
                            np.asarray(wg.opacities)[keep.numpy()]),
              "depth": (out.depth, want.depth),
              "extrinsic_c2w": (out.extrinsic_c2w, want.extrinsic_c2w),
              "intrinsic_norm": (out.intrinsic_norm, want.intrinsic_norm)}
    assert _rel(*fields[name]) <= tol
    assert tuple(g.means.shape) == (1, 13 * 56 * 56, 3)


@pytest.mark.parametrize("shape,size", [((1, 3, 2, 64, 64), (56, 56)),
                                        ((1, 3, 1, 512, 512), (448, 448)),
                                        ((2, 3, 1, 20, 30), (45, 40))])
def test_resize_matches_jax_antialiased(rng, shape, size):
    """The JAX resize antialiases when it shrinks; the port follows it,
    which sets both apart from a plain trilinear resize."""
    video = rng.uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jt.resize_trilinear_half_pixel(jnp.asarray(video),
                                                     size))
    got = tt.resize_trilinear_half_pixel(torch.from_numpy(video), size)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    if size[0] < shape[3]:
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(video), size=(shape[2], *size),
            mode="trilinear", align_corners=False)
        assert float((plain - got).abs().max()) > 0.05


def _cameras(rng, b=1, v=13):
    q = rng.normal(size=(b, v, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                    2 * (x * z + y * w), 2 * (x * y + z * w),
                    1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                    2 * (x * z - y * w), 2 * (y * z + x * w),
                    1 - 2 * (x * x + y * y)], -1).reshape(b, v, 3, 3)
    c2w = np.tile(np.eye(4), (b, v, 1, 1))
    c2w[..., :3, :3] = rot
    c2w[..., :3, 3] = rng.normal(size=(b, v, 3))
    k = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]]),
                (b, v, 1, 1)) + rng.uniform(-0.05, 0.05, (b, v, 3, 3))
    return c2w.astype(np.float32), k.astype(np.float32)


@pytest.mark.parametrize("t", [10, 1, 0])
def test_interpolate_cameras_is_exact(rng, t):
    c2w, k = _cameras(rng, b=2)
    want = jvid.interpolate_cameras(c2w, k, t)
    got = tvid.interpolate_cameras(c2w, k, t)
    assert got[0].shape == (2, 12 * (t + 1) + 1, 4, 4)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_turbo_is_matplotlibs(rng):
    from matplotlib import cm

    x = np.concatenate([rng.uniform(-0.2, 1.2, 5000),
                        [0.0, 1.0, -1e-9, 1 + 1e-7, np.nan, 0.5]]) \
        .astype(np.float32)
    np.testing.assert_array_equal(tturbo.turbo(x), cm.turbo(x)[..., :3])
    assert len(tturbo.TURBO) == 256


def test_turbo_depth_is_exact(rng):
    depth = rng.uniform(0.5, 4.0, (27, 8, 10)).astype(np.float32)
    depth[3, 2, 2] = 40.0                    # above the 99 % quantile
    for n in (13, 1):
        got = tvid.turbo_depth(depth, n)
        want = jvid.turbo_depth(depth, n)
        assert got.dtype == want.dtype and got.shape == (27, 3, 8, 10)
        np.testing.assert_array_equal(got, want)


def test_ply_bytes_equal_the_jax_packages(rng, tmp_path):
    """The JAX package's defaults, which the export uses: the DC band, no
    shift-and-scale."""
    g = 257
    means = rng.normal(size=(g, 3)).astype(np.float32)
    scales = rng.uniform(1e-4, 0.3, (g, 3)).astype(np.float32)
    rot = rng.normal(size=(g, 4)).astype(np.float32)
    harm = rng.normal(size=(g, 3, 25)).astype(np.float32)
    op = rng.uniform(size=g).astype(np.float32)
    want = jply.export_ply(means, scales, rot, harm, op, tmp_path / "j.ply")
    got = tply.export_ply(*(torch.from_numpy(x) for x in
                            (means, scales, rot, harm, op)),
                          tmp_path / "t" / "t.ply")
    assert got.read_bytes() == want.read_bytes()
    back, ref = tply.load_ply(got), jply.load_ply(want)
    assert list(back) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])


def test_orbit_render_of_the_same_gaussians_matches_jax(decoded):
    """The first two orbit views of the JAX decode's Gaussians, rendered by
    both packages at 56²."""
    _, (want, _), _ = decoded
    ex, kk = jvid.interpolate_cameras(np.asarray(want.extrinsic_c2w),
                                      np.asarray(want.intrinsic_norm), 1)
    ex, kk = ex[:, :2], kk[:, :2]
    wg = want.gaussians
    ref = jsd.render(wg, jnp.asarray(ex), jnp.asarray(kk), (56, 56))
    tg = TGaussians(*(torch.from_numpy(np.array(x)) for x in wg))
    tr.reset_launch_counts()
    got = tsd.render(tg, torch.from_numpy(ex), torch.from_numpy(kk),
                     (56, 56), device="cpu")
    assert tr.launches == 0
    for a, b, atol in ((got.color, ref.color, 2e-5),
                       (got.depth, ref.depth, 2e-4),
                       (got.alpha, ref.alpha, 2e-5)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        off = np.abs(a - b) > atol + 1e-4 * np.abs(b)
        assert off.mean() <= 0.005, off.mean()
    assert float(got.alpha.mean()) > 0.5          # the scene covers the view


def test_export_artifacts_writes_what_the_user_gets(decoded, tmp_path):
    (out, _), _, _ = decoded
    arts = tt.export_artifacts(out.gaussians, out.extrinsic_c2w,
                               out.intrinsic_norm, str(tmp_path / "scene"),
                               (32, 32), orbit_t=0, device="cpu")
    assert arts.color.shape == (13, 3, 32, 32)
    assert arts.depth.shape == (13, 32, 32)
    assert np.isfinite(arts.color).all() and np.isfinite(arts.depth).all()
    assert arts.color.min() >= 0 and arts.color.max() <= 1
    assert os.path.getsize(arts.gs_path) > 0
    assert os.path.getsize(arts.depth_path) > 0
    ply = tply.load_ply(arts.ply_path)
    assert len(ply["x"]) == 13 * 56 * 56
    np.testing.assert_array_equal(ply["x"],
                                  out.gaussians.means[0, :, 0].numpy())
    np.testing.assert_allclose(np.exp(ply["scale_0"]),
                               out.gaussians.scales[0, :, 0].numpy(),
                               rtol=1e-5, atol=1e-7)
