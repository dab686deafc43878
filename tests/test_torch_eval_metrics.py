"""Image metrics of the port (`eval/metrics.py`) against the JAX package's
`vist3a_tpu/eval/metrics.py`, on the CPU, the same numpy inputs from a
seed.

  * PSNR and SSIM: within 1e-5 relative (fp32; the same separable 11-tap
    Gaussian window, each library's convolution summing in its own order);
    infinite PSNR on equal images in both;
  * LPIPS-VGG16 with JAX `lpips_init` weights carried over by
    `convert.load_jax_lpips_params`: within 1e-5 relative (13 fp32
    convolutions at 32², then the channel norms), 0 on equal images;
  * `import_lpips_vgg` on torchvision / lpips-named state dicts (random,
    from a seed) gives both packages the same network: the same LPIPS;
  * the port's own `lpips_init` (a torch generator) has the JAX package's
    shapes and draws heads |N(0, 1)|·0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.eval import metrics as jm
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.eval import metrics as tm

RTOL = 1e-5
jlpips = jax.jit(jm.compute_lpips)      # one compile, not one per op


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(jm.lpips_init)(jax.random.key(0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed: int, shape=(2, 3, 32, 32)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(shape, np.float32), 0, 1)
    return x, y.astype(np.float32)


def test_psnr_and_ssim_match_jax():
    x, y = _pair(0, (2, 3, 40, 36))
    for fn_t, fn_j in ((tm.compute_psnr, jm.compute_psnr),
                       (tm.compute_ssim, jm.compute_ssim)):
        got = fn_t(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isposinf(tm.compute_psnr(torch.from_numpy(x),
                                       torch.from_numpy(x)).numpy()).all()
    np.testing.assert_allclose(
        tm.compute_ssim(torch.from_numpy(x), torch.from_numpy(x)).numpy(),
        1.0, atol=1e-5)


def test_ssim_is_differentiable():
    x, y = _pair(1)
    yt = torch.from_numpy(y).requires_grad_(True)
    tm.compute_ssim(torch.from_numpy(x), yt).sum().backward()
    assert torch.isfinite(yt.grad).all() and yt.grad.abs().max() > 0


def test_lpips_matches_jax(jparams):
    params = jparams
    model = convert.load_jax_lpips_params(
        tm.LPIPSVGG(), jax.tree_util.tree_map(np.asarray, params)).eval()
    x, y = _pair(2)
    got = tm.compute_lpips(model, torch.from_numpy(x),
                           torch.from_numpy(y)).numpy()
    want = np.asarray(jlpips(params, jnp.asarray(x), jnp.asarray(y)))
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(tm.compute_lpips(
        model, torch.from_numpy(x), torch.from_numpy(x)).numpy(), 0.0,
        atol=1e-6)


def test_import_lpips_vgg_matches_jax():
    rng = np.random.default_rng(4)
    vgg, lpips, c_in, idx = {}, {}, 3, 0
    for s, (c_out, n) in enumerate(tm.VGG16_PLAN):
        for _ in range(n):
            f = tm.VGG16_CONV_INDICES[idx]
            vgg[f"features.{f}.weight"] = (rng.standard_normal(
                (c_out, c_in, 3, 3)) / np.sqrt(9 * c_in)).astype(np.float32)
            vgg[f"features.{f}.bias"] = (0.01 * rng.standard_normal(c_out)
                                         ).astype(np.float32)
            c_in, idx = c_out, idx + 1
        lpips[f"lin{s}.model.1.weight"] = np.abs(rng.standard_normal(
            (1, c_out, 1, 1))).astype(np.float32) * 0.1
    model = tm.import_lpips_vgg(
        {k: torch.from_numpy(v) for k, v in lpips.items()},
        {k: torch.from_numpy(v) for k, v in vgg.items()}, device="cpu")
    params = jm.import_lpips_vgg(lpips, vgg)
    x, y = _pair(3, (1, 3, 32, 32))
    got = tm.compute_lpips(model, torch.from_numpy(x),
                           torch.from_numpy(y)).numpy()
    want = np.asarray(jlpips(params, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_lpips_init_draws_the_jax_shapes(jparams):
    model = tm.lpips_init(torch.Generator().manual_seed(0), device="cpu")
    params = jparams
    want = convert.from_jax_params(
        {"convs": [[{"kernel": np.asarray(c["kernel"]).transpose(
            3, 2, 0, 1), "bias": np.asarray(c["bias"])} for c in stage]
            for stage in params["convs"]]})
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in got.items() if k.startswith("convs")}
    for lin, (c, _) in zip(model.lins, tm.VGG16_PLAN):
        assert lin.shape == (c,) and (lin >= 0).all() and lin.max() < 1.0
