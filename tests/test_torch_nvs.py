"""The NVS evaluation of the port (`stitch/chopped_anysplat.py::
forward_from_video`, `eval/nvs.py`, `cli/nvs_eval.py`,
`cli/model_loading.py` with the VAE encoder) against the JAX package's, on
the CPU.

  * `forward_from_video` at `test_torch_slice.py`'s tiny stitched config,
    a tiny Wan VAE (base_dim 8) and 5 frames (VAE 64², feed-forward 56²),
    JAX `init` weights carried over: the posterior mean encoded, then the
    decoder; every output within 1e-3 of its largest magnitude (the slice
    test's fp32 limit; observed ≤ 1e-5);
  * `inference_nvs` through the `forward_fn` hook both packages take, both
    handed the same fixed outputs (the 48-Gaussian scene of
    `tests/test_post_opt.py`, random cameras for each pass): the inputs of
    both passes equal bit for bit, the rendered targets within 1e-4 (the
    composite's plain version against the Pallas kernel in interpret
    mode).  Only the pass logic, the scale alignment and the render are
    compared: JAX's whole bench takes minutes on a CPU;
  * `compute_metrics_for_dir` (PSNR, SSIM, LPIPS with JAX `lpips_init`
    weights) and `write_metric_csvs` on one directory of PNGs: within
    1e-5 relative, the same CSV columns;
  * `cli/nvs_eval.py::main` end to end on tiny reference-format files:
    `chip_smoke.drive_evaluation`, phase `evaluation`'s own code (the
    writers, the main, the checks of the PNGs, the CSVs against a float64
    recomputation, the VAE encoder bit for bit as written, and a refine of
    pass 1's Gaussians), with both packages' configs monkeypatched to the
    tiny ones and the deployed-manifest gate off.
"""

import csv
import functools
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository's root script)
from test_post_opt import scene  # noqa: F401,E402  (the JAX test's fixture)
from test_torch_slice import CAMERA_BIAS, _configs  # noqa: E402
from vist3a_tpu.eval import metrics as jm  # noqa: E402
from vist3a_tpu.eval import nvs as jnvs  # noqa: E402
from vist3a_tpu.io import weight_import as jwi  # noqa: E402
from vist3a_tpu.nn import wan_vae as jvae  # noqa: E402
from vist3a_tpu.stitch import chopped_anysplat as jca  # noqa: E402
from vist3a_tpu_torch import convert  # noqa: E402
from vist3a_tpu_torch.cli import model_loading as tml  # noqa: E402
from vist3a_tpu_torch.eval import metrics as tm  # noqa: E402
from vist3a_tpu_torch.eval import nvs as tnvs  # noqa: E402
from vist3a_tpu_torch.io import manifests as tmf  # noqa: E402
from vist3a_tpu_torch.nn import wan_vae as tvae  # noqa: E402
from vist3a_tpu_torch.nn.encoder import Encoder  # noqa: E402
from vist3a_tpu_torch.nn.gaussians import Gaussians  # noqa: E402
from vist3a_tpu_torch.nn.layers import build_random  # noqa: E402
from vist3a_tpu_torch.stitch import chopped_anysplat as tca  # noqa: E402

VAE = dict(base_dim=8, z_dim=16, num_res_blocks=1)
FORWARD_RTOL = 1e-3
RENDER_ATOL = 1e-4
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def test_forward_from_video_matches_jax():
    """Both packages' weights from the port's seeded modules through the
    reference format: the fabricators' state dicts, read by the JAX
    importers (the JAX `init` of the tiny encoder and VAE takes ~1 min
    on a CPU)."""
    jcfg, tcfg = _configs()
    vcfg = tvae.WanVAEConfig(**VAE)
    jcfg = jca.StitchedConfig(encoder=jcfg.encoder, stitch_layer_index=2,
                              conv_spec=jcfg.conv_spec,
                              vae=jvae.WanVAEConfig(**VAE))
    gen = torch.Generator().manual_seed(5)
    enc = build_random(lambda: Encoder(tcfg.encoder), gen, "cpu",
                       torch.float32)
    enc.camera_head.pose_branch.fc2.bias.copy_(torch.from_numpy(CAMERA_BIAS))
    halves = (tvae.init_encoder(vcfg, gen, device="cpu"),
              tvae.init_decoder(vcfg, gen, device="cpu"))

    def ref(sd):
        return {k: v.numpy() for k, v in sd.items()}
    params = {"encoder": jwi.import_anysplat_encoder(
                  ref(tmf._fab_anysplat_encoder(enc))),
              "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg),
              "vae": jwi.import_wan_vae(ref(tmf._fab_wan_vae(*halves)),
                                        jcfg.vae)}
    rng = np.random.default_rng(0)
    video = rng.uniform(-1, 1, (1, 3, 5, 64, 64)).astype(np.float32)
    images = rng.uniform(-1, 1, (1, 3, 5, 56, 56)).astype(np.float32)
    want = jax.jit(functools.partial(jca.forward_from_video, cfg=jcfg,
                                     remat=False))(
        params, jnp.asarray(video), jnp.asarray(images))

    host = jax.tree_util.tree_map(np.asarray, params)
    model = convert.load_jax_params(
        tca.StitchedDecoder(tcfg),
        {"encoder": host["encoder"], "stitch_conv": host["stitch_conv"]})
    encoder = convert.load_jax_vae_params(tvae.WanVAEEncoder(vcfg),
                                          host["vae"])
    for k, v in encoder.state_dict().items():
        assert torch.equal(v, halves[0].state_dict()[k]), k
    got = tca.forward_from_video(model.eval(), encoder.eval(),
                                 torch.from_numpy(video),
                                 torch.from_numpy(images), tcfg,
                                 device="cpu")
    g, wg = got.gaussians, want.gaussians
    for name, a, b in (("means", g.means, wg.means),
                       ("harmonics", g.harmonics, wg.harmonics),
                       ("opacities", g.opacities, wg.opacities),
                       ("extrinsic_c2w", got.extrinsic_c2w,
                        want.extrinsic_c2w),
                       ("intrinsic_norm", got.intrinsic_norm,
                        want.intrinsic_norm),
                       ("depth", got.depth, want.depth)):
        assert _rel(a, b) <= FORWARD_RTOL, name
    # with a generator the latent is a posterior sample: another output
    drawn = tca.forward_from_video(model, encoder, torch.from_numpy(video),
                                   torch.from_numpy(images), tcfg,
                                   generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    assert not torch.equal(drawn.gaussians.means, got.gaussians.means)


class _Out(NamedTuple):
    gaussians: object
    extrinsic_c2w: object
    intrinsic_norm: object


def _cameras(rng, s: int) -> tuple[np.ndarray, np.ndarray]:
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, s, 1, 1))
    c2w[0, :, 0, 3] = rng.uniform(-0.4, 0.4, s)
    c2w[0, :, 1, 3] = rng.uniform(-0.1, 0.1, s)
    k = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]],
                         np.float32), (1, s, 1, 1))
    return c2w, k


def test_inference_nvs_matches_jax(scene):  # noqa: F811
    gaussians = scene[0]
    rng = np.random.default_rng(1)
    v, targets = 8, [7, 6, 5, 4]
    images01 = rng.random((v, 3, 8, 8), dtype=np.float32)
    vae01 = rng.random((v, 3, 16, 16), dtype=np.float32)
    cams = {5: _cameras(rng, 5), 9: _cameras(rng, 9)}
    tg = Gaussians(*(torch.from_numpy(np.array(x)) for x in gaussians))
    seen = {"jax": [], "torch": []}

    def jfwd(vae_pm1, ff_pm1):
        seen["jax"].append((np.asarray(vae_pm1), np.asarray(ff_pm1)))
        ex, k = cams[vae_pm1.shape[2]]
        return _Out(gaussians, jnp.asarray(ex), jnp.asarray(k))

    def tfwd(vae_pm1, ff_pm1):
        seen["torch"].append((vae_pm1.numpy(), ff_pm1.numpy()))
        ex, k = cams[vae_pm1.shape[2]]
        return _Out(tg, torch.from_numpy(ex), torch.from_numpy(k))

    want = jnvs.inference_nvs(None, images01, vae01, targets, None,
                              render_hw=(32, 32), pair_budget=4096,
                              forward_fn=jfwd)
    got = tnvs.inference_nvs(None, images01, vae01, targets, None,
                             render_hw=(32, 32), pair_budget=4096,
                             forward_fn=tfwd, device="cpu")
    assert [x[0].shape[2] for x in seen["torch"]] == [5, 9]
    for (ja, jb), (ta, tb) in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
    assert got.shape == (4, 3, 32, 32) and got.max() > 0.05
    np.testing.assert_allclose(got, np.asarray(want), atol=RENDER_ATOL)


def test_metrics_for_dir_and_csvs_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    for seq in ("a", "b"):
        for kind in ("gt", "pred"):
            (tmp_path / "images" / seq / kind).mkdir(parents=True)
        for i in range(3):
            x = rng.integers(0, 256, (40, 48, 3), np.uint8)
            y = np.clip(x + rng.integers(-30, 30, x.shape), 0, 255)
            Image.fromarray(x).save(tmp_path / "images" / seq / "gt"
                                    / f"{i:0>6}.png")
            Image.fromarray(y.astype(np.uint8)).save(
                tmp_path / "images" / seq / "pred" / f"{i:0>6}.png")
    params = jax.jit(jm.lpips_init)(jax.random.key(0))
    monkeypatch.setattr(jm, "compute_lpips", jax.jit(jm.compute_lpips))
    want = jnvs.compute_metrics_for_dir(tmp_path / "images",
                                        lpips_params=params)
    model = convert.load_jax_lpips_params(
        tm.LPIPSVGG(), jax.tree_util.tree_map(np.asarray, params))
    got = tnvs.compute_metrics_for_dir(tmp_path / "images",
                                       lpips_model=model, device="cpu")
    assert [r["sequence"] for r in got["per_sequence"]] == ["a", "b"]
    for g, w in zip(got["per_sequence"] + [got["overall"]],
                    want["per_sequence"] + [want["overall"]]):
        assert g.keys() == w.keys()
        for k in ("psnr", "ssim", "lpips"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL)
    jnvs.write_metric_csvs(want, tmp_path / "jax")
    tnvs.write_metric_csvs(got, tmp_path / "torch")
    for name in ("per_sequence.csv", "overall.csv"):
        with open(tmp_path / "jax" / name) as f:
            jrows = list(csv.DictReader(f))
        with open(tmp_path / "torch" / name) as f:
            trows = list(csv.DictReader(f))
        assert [r.keys() for r in trows] == [r.keys() for r in jrows]
        for t, j in zip(trows, jrows):
            for k in t:
                if k == "sequence":
                    assert t[k] == j[k]
                else:
                    np.testing.assert_allclose(float(t[k]), float(j[k]),
                                               rtol=METRIC_RTOL)


@pytest.fixture
def tiny_gate_off(monkeypatch):
    """The port's loaders at the tiny configs, the deployed-manifest gate
    off."""
    _, tcfg = _configs()
    monkeypatch.setattr(tmf, "validate_state_dict", lambda sd, f, **k: True)
    monkeypatch.setattr(tml, "EncoderConfig", lambda: tcfg.encoder)
    monkeypatch.setattr(tml, "WanVAEConfig",
                        functools.partial(tvae.WanVAEConfig, **VAE))
    return tcfg


def test_main_on_reference_files_at_tiny_sizes(tiny_gate_off, tmp_path):
    """`chip_smoke.drive_evaluation`, phase `evaluation`'s own code, on the
    CPU: 2 sequences of 8 frames at 96×72, VAE 64², feed-forward 56²."""
    tcfg = tiny_gate_off
    vcfg = tvae.WanVAEConfig(**VAE)
    gen = torch.Generator().manual_seed(11)
    src = {"encoder": build_random(lambda: Encoder(tcfg.encoder), gen,
                                   "cpu", torch.float32),
           "vae_encoder": tvae.init_encoder(vcfg, gen, device="cpu"),
           "vae_decoder": tvae.init_decoder(vcfg, gen, device="cpu")}
    src["encoder"].camera_head.pose_branch.fc2.bias.copy_(
        torch.from_numpy(CAMERA_BIAS))
    res = chip_smoke.drive_evaluation(
        src, tcfg, tmp_path, device="cpu", frames=8, hw=(72, 96),
        flags=("--resolution", "64", "--feedforward_resolution", "56"),
        refine_steps=6)
    assert sorted(p.name for p in (tmp_path / "weights").iterdir()) == \
        ["anysplat.pth", "anysplat_stitched.pth", "wan_vae"]
    assert res["pass1_gaussians"] == 5 * 56 * 56
    assert res["compared"]["vae_encoder"] > 10
    assert len(res["result"]["per_sequence"]) == 2
    assert np.isfinite(res["result"]["overall"]["psnr"])
    assert res["post_opt"]["views"] == 4 and res["post_opt"]["ratio"] < 1
    assert max(res["info"]["calls"]["encode"]) > 0
    assert len(res["info"]["calls"]["forward_with_latent"]) == 4
    assert len(res["info"]["calls"]["render"]) == 2
