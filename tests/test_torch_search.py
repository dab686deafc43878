"""The port's stitching-layer search against the JAX package's
(`vist3a_tpu/search/ridge.py`, `vist3a_tpu/cli/find_layer.py`).

  * `unfold3d`, `upsample_latent_np` and `fit_conv3d_streaming` are the
    JAX package's host float64 numpy, line for line: equal within 1e-10 on
    the same inputs (observed: bit for bit).  The fit recovers a planted
    conv, judged by the port's own `ConvSpec.apply`.
  * The taps (`nn/vit.py::block_taps`, `extract_block_features`) at the
    tiny encoder of `tests/test_torch_slice.py`, JAX `init` weights through
    `convert`: every block's features within one fp16 step of JAX's plus
    1e-5 of the largest (both cast fp32 features to fp16; the fp32
    features differ by ≤ 7.5e-7 of the largest, sums in another order, and
    a value can round to the neighbouring fp16), and the last tap equal to
    the trunk's own blocks before the final norm.
  * `find_layer.run` on the fake loader of `tests/test_cli_runs.py`, the
    JAX posterior noise handed in (`posterior_eps`): the same best layer,
    MSEs within 1e-4 relative, the same artifacts; a second run reads the
    cache and gives the same result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli_runs import FakeClipLoader
from test_torch_slice import _configs
from vist3a_tpu.cli import find_layer as jfind
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import wan_vae as jvae
from vist3a_tpu.search import ridge as jridge
from vist3a_tpu.stitch.conv_spec import parse_conv_spec as jparse
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.cli import find_layer as tfind
from vist3a_tpu_torch.io import checkpoints as tckpt
from vist3a_tpu_torch.nn import encoder as tenc
from vist3a_tpu_torch.nn import vit as tvit
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.search import ridge as tridge
from vist3a_tpu_torch.stitch.conv_spec import parse_conv_spec as tparse

SPEC_STR = "conv3d_k5x3x3_o12_s1x2x2_p2x1x1"
VAE = dict(base_dim=8, z_dim=16, num_res_blocks=1)
FIT_ATOL = 1e-10
MSE_RTOL = 1e-4
FP16_STEP = 2 ** -10          # one fp16 step, relative
TAP_RTOL = 1e-5               # fp32 features, of the largest (seen 7.5e-7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The tiny trunk and a tiny Wan VAE encoder in both packages."""
    jcfg, tcfg = _configs()
    jparams = jenc.init(jax.random.key(0), jcfg.encoder)
    enc = convert.load_jax_encoder_params(
        tenc.Encoder(tcfg.encoder, vit_start=0),
        jax.tree_util.tree_map(np.asarray, jparams))
    jvcfg = jvae.WanVAEConfig(**VAE)
    jv = jvae.init(jax.random.key(1), jvcfg)
    tv = convert.load_jax_vae_params(tvae.WanVAEEncoder(
        tvae.WanVAEConfig(**VAE)), jax.tree_util.tree_map(np.asarray, jv))
    return {"jvit": jparams["vit"], "jcfg": jcfg.encoder.vit, "jvae": jv,
            "jvae_cfg": jvcfg, "vit": enc.vit.requires_grad_(False),
            "cfg": tcfg.encoder.vit, "vae": tv.requires_grad_(False)}


def test_unfold_and_upsample_equal_jax(rng):
    spec = tparse(SPEC_STR)
    z = rng.standard_normal((2, 6, 3, 7, 9))
    for up in (tridge.upsample_latent_np(z, (7, 9)),
               tridge.upsample_latent_np(z, (10, 12))):
        want = jridge.upsample_latent_np(z, up.shape[-2:])
        np.testing.assert_allclose(up, want, rtol=0, atol=FIT_ATOL)
        got = tridge.unfold3d(up, spec.kernel_size, spec.stride, spec.padding)
        np.testing.assert_allclose(got, jridge.unfold3d(
            up, spec.kernel_size, spec.stride, spec.padding), rtol=0,
            atol=FIT_ATOL)
    # the design matrix is the deployed conv's input: the unfold's einsum
    # with a kernel equals the port's replicate-padded conv
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(12, 6, 5, 3, 3, generator=gen, dtype=torch.float64)
    b = torch.randn(12, generator=gen, dtype=torch.float64)
    zt = torch.from_numpy(z)
    conv = spec.apply(w, b, zt).numpy()
    p = tridge.unfold3d(z, spec.kernel_size, spec.stride, spec.padding)
    mine = np.einsum("ncijkthw,ocijk->nothw", p, w.numpy()) \
        + b.numpy()[None, :, None, None, None]
    np.testing.assert_allclose(mine, conv, rtol=1e-12, atol=1e-12)


def _planted(rng, spec, n=48, c=6, t_vae=2, hw=6):
    """Latents and the targets of a zero-bias conv on their upsampling."""
    gen = torch.Generator().manual_seed(1)
    w = (torch.rand(spec.kernel_shape(c), generator=gen,
                    dtype=torch.float64) * 2 - 1) * 0.2
    z_batches = [rng.standard_normal((c, t_vae, hw, hw)) * 0.7
                 for _ in range(n)]
    y_batches = []
    for z in z_batches:
        up = torch.from_numpy(tridge.upsample_latent_np(z[None], (hw, hw)))
        out = spec.apply(w, None, up)[0].numpy()          # (O, T, H', W')
        o, t, h2, w2 = out.shape
        y_batches.append(out.transpose(1, 2, 3, 0).reshape(t, h2 * w2, o))
    return w, z_batches, y_batches


def test_fit_equals_jax_and_recovers_a_planted_conv(rng):
    spec = tparse(SPEC_STR)
    w, z_batches, y_batches = _planted(rng, spec)
    params, mse = tridge.fit_conv3d_streaming(spec, z_batches, y_batches,
                                              ridge=1e-6)
    jparams, jmse = jridge.fit_conv3d_streaming(jparse(SPEC_STR), z_batches,
                                                y_batches, ridge=1e-6)
    assert params["kernel"].dtype == np.float32
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(params[k], np.asarray(jparams[k]),
                                   rtol=0, atol=FIT_ATOL)
    assert abs(mse - jmse) <= FIT_ATOL and mse < 1e-6
    # the kernel is not identifiable (T_vae = 2 spans every upsampled
    # frame); the fitted conv must match the planted one on new latents
    z_new = rng.standard_normal((1, 6, 2, 6, 6))
    up = torch.from_numpy(tridge.upsample_latent_np(z_new, (6, 6)))
    got = spec.apply(torch.from_numpy(params["kernel"]).double(),
                     torch.from_numpy(params["bias"]).double(), up)
    want = spec.apply(w, None, up)
    assert float((got - want).abs().max()) < 1e-3
    assert tridge.rank_layers({"enc_blocks_1": 0.5, "enc_blocks_2": 0.1,
                               "enc_blocks_3": 0.9}) == "enc_blocks_2"


def test_taps_match_jax(models, rng):
    images = rng.uniform(0, 1, (1, 2, 3, 56, 56)).astype(np.float32)
    want = jridge.extract_block_features(models["jvit"], jnp.asarray(images),
                                         models["jcfg"])
    got = tridge.extract_block_features(models["vit"],
                                        torch.from_numpy(images),
                                        models["cfg"])
    assert len(got) == len(want) == models["cfg"].depth
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float16 and tuple(g.shape) == w.shape \
            == (1, 2, 16, models["cfg"].embed_dim)
        g = g.float().numpy()
        assert np.all(np.abs(g - w) <= FP16_STEP * np.abs(w)
                      + TAP_RTOL * np.abs(w).max())
    # the last tap is the trunk's own block output before the final norm
    imgs = torch.from_numpy(images[0])
    cfg = models["cfg"]
    taps = tvit.block_taps(models["vit"], imgs, cfg)
    x = tvit.prepare_tokens(models["vit"], models["vit"].patch_proj(imgs),
                            (4, 4), cfg)
    for blk in models["vit"].blocks.values():
        x = blk(x)
    assert torch.equal(taps[-1], x)
    feats = tvit.forward_features(models["vit"], imgs, cfg)
    assert torch.equal(models["vit"].norm(x)[:, 5:], feats)


def _jax_noise(n_steps: int, shape) -> list:
    """`find_layer.run`'s posterior noise: normal(fold_in(key(0), step))."""
    key = jax.random.key(0)
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                         jnp.float32)) for i in range(n_steps)]


def test_find_layer_run_matches_jax(models, tmp_path):
    loader = FakeClipLoader(2, n_views=5, vae_hw=64, ff_hw=56)
    best_j, mses_j = jfind.run(
        models["jvit"], models["jvae"], models["jcfg"], models["jvae_cfg"],
        jparse(SPEC_STR), loader, feature_save_path=tmp_path / "jax",
        iterations=2)
    eps = _jax_noise(2, (1, 16, 2, 8, 8))
    best, mses = tfind.run(
        models["vit"], models["vae"], models["cfg"], tparse(SPEC_STR), loader,
        feature_save_path=tmp_path / "torch", iterations=2,
        posterior_eps=eps)
    assert best == best_j and mses.keys() == mses_j.keys()
    assert len(mses) == models["cfg"].depth
    for k in mses:
        assert abs(mses[k] - mses_j[k]) <= MSE_RTOL * mses_j[k], k
    mine = {p.name for p in (tmp_path / "torch").iterdir()}
    assert mine == {p.name for p in (tmp_path / "jax").iterdir()}
    art = tckpt.load_search_artifact(tmp_path / "torch"
                                     / f"state_dict_{best}.npz")
    assert art["kernel"].shape == (models["cfg"].embed_dim, 16, 5, 3, 3)
    assert art["bias"].shape == (models["cfg"].embed_dim,)
    # the cache: the features and every layer's files are read back
    stamp = {p.name: p.stat().st_mtime_ns
             for p in (tmp_path / "torch").iterdir()}

    class NoBatches:
        def __iter__(self):
            raise AssertionError("the cached run reads no batch")
    best2, mses2 = tfind.run(
        models["vit"], models["vae"], models["cfg"], tparse(SPEC_STR),
        NoBatches(), feature_save_path=tmp_path / "torch", iterations=2)
    assert best2 == best and mses2 == pytest.approx(mses, rel=1e-15)
    assert stamp == {p.name: p.stat().st_mtime_ns
                     for p in (tmp_path / "torch").iterdir()}
