"""The whole text→3DGS slice of the port against the JAX package.

The tiny `T23DConfig` of `tests/test_t23d_pipeline.py` (UMT5 d_model 40,
2 layers, 32 tokens; DiT dim 48, 2 layers; 64² video of 13 frames from a
(1, 16, 4, 8, 8) latent; the tiny stitched decoder of `test_torch_slice`,
56² feed-forward images, 40,768 Gaussians), with 3 UniPC steps and
guidance 3.0.  Weights from the JAX `init` through `convert`; a seeded fake
tokenizer; the noise made with numpy and passed to both sides as
`latents0` (the port's own draw comes from a torch generator, which gives
other numbers than `jax.random`).

Tolerances, with their reasons:
  * prompt embeddings and denoised latents (fp32 end to end): 1e-5 of
    their range — UMT5, 3 CFG-batched DiT calls and the UniPC chain, each
    side summing in its own order;
  * the decode after it: the allowances of `test_torch_export.py`, since
    the VAE decodes in bf16 on both sides: video max 2⁻³ and mean 2⁻⁶;
    means, depth and cameras 1e-3 of their range; the confidence masks
    agree on all but 0.1 % of the pixels (the 10 % quantile may move a
    pixel across it).
"""

import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_export import _tiny_configs
from test_torch_slice import CAMERA_BIAS
from test_torch_vae import decoder_params
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import umt5 as jumt5
from vist3a_tpu.nn import wan_dit as jdit
from vist3a_tpu.pipelines import t23d as jt
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.core import profiling as tprof
from vist3a_tpu_torch.io import ply_export as tply
from vist3a_tpu_torch.kernels import flash_attention as fa
from vist3a_tpu_torch.nn import umt5 as tumt5
from vist3a_tpu_torch.nn import wan_dit as tdit
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.pipelines import t23d as tt
from vist3a_tpu_torch.stitch import chopped_anysplat as tca

DIT = dict(dim=48, ffn_dim=96, num_layers=2, num_heads=4, freq_dim=32,
           text_dim=40)
UMT5 = dict(vocab_size=64, d_model=40, d_kv=10, num_heads=4, d_ff=64,
            num_layers=2, max_sequence_length=32)
STEPS = dict(num_inference_steps=3, guidance_scale=3.0)
PROMPT = "a red chair in a garden"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain composite of the export runs thousands of small ops; under
    the suite's parallel workers torch's intra-op threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    jcfg, tcfg = _tiny_configs()
    jcfg = dataclasses.replace(jcfg, dit=jdit.WanDiTConfig(**DIT),
                               umt5=jumt5.UMT5Config(**UMT5), **STEPS)
    tcfg = dataclasses.replace(tcfg, dit=tdit.WanDiTConfig(**DIT),
                               umt5=tumt5.UMT5Config(**UMT5), **STEPS)
    return jcfg, tcfg


def tokenize(text):
    """Seeded by the text: (ids (1, 32), mask with one 1 per word)."""
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    n = UMT5["max_sequence_length"]
    ids = rng.integers(0, UMT5["vocab_size"], (1, n))
    mask = np.zeros((1, n), np.int64)
    mask[0, : min(len(text.split()), n)] = 1
    return ids, mask


@pytest.fixture(scope="module")
def slices():
    """(JAX params, the port's modules, numpy noise) of the tiny config."""
    jcfg, tcfg = _configs()
    params = {
        "umt5": jumt5.init(jax.random.key(5), jcfg.umt5),
        "dit": jdit.init(jax.random.key(6), jcfg.dit),
        "encoder": jax.jit(lambda k: jenc.init(k, jcfg.stitched.encoder))(
            jax.random.key(0)),
        "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg.stitched),
        "vae": jax.jit(decoder_params)(jax.random.key(2))}
    params["encoder"]["camera_head"]["pose_branch"]["fc2"]["b"] = \
        jnp.asarray(CAMERA_BIAS)
    params = jax.tree_util.tree_map(np.asarray, params)
    modules = {
        "umt5": convert.load_jax_umt5_params(
            tumt5.UMT5Encoder(tcfg.umt5), params["umt5"]).eval(),
        "dit": convert.load_jax_dit_params(
            tdit.WanDiT(tcfg.dit), params["dit"]).eval(),
        "vae": convert.load_jax_vae_params(
            tvae.WanVAEDecoder(tcfg.vae), params["vae"]).eval(),
        "stitched": convert.load_jax_params(
            tca.StitchedDecoder(tcfg.stitched),
            {k: params[k] for k in ("encoder", "stitch_conv")}).eval()}
    z = np.random.default_rng(0).standard_normal(jcfg.latent_shape) \
        .astype(np.float32)
    return params, modules, z


@pytest.fixture(scope="module")
def runs(slices):
    """Each side's embed → denoise → decode on the same noise."""
    params, modules, z = slices
    jcfg, tcfg = _configs()
    cond, uncond = jt.embed_prompts(params["umt5"], tokenize, PROMPT, jcfg)
    lat = jt.denoise(params["dit"], cond, uncond, jcfg,
                     latents0=jnp.asarray(z))
    out, video = jax.jit(lambda p, x: jt.decode_and_reconstruct(p, x, jcfg))(
        {k: params[k] for k in ("vae", "stitch_conv", "encoder")}, lat)
    want = dict(cond=cond, uncond=uncond, latents=lat, out=out, video=video)

    t_cond, t_uncond = tt.embed_prompts(modules["umt5"], tokenize, PROMPT,
                                        device="cpu")
    t_lat = tt.denoise(modules["dit"], t_cond, t_uncond, tcfg,
                       latents0=torch.from_numpy(z), device="cpu")
    t_out, t_video = tt.decode_and_reconstruct(
        modules["vae"], modules["stitched"], t_lat, tcfg, device="cpu")
    got = dict(cond=t_cond, uncond=t_uncond, latents=t_lat, out=t_out,
               video=t_video)
    return got, want


def _rel(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["cond", "uncond", "latents"])
def test_embed_and_denoise_match_jax(runs, name):
    got, want = runs
    assert got[name].dtype == torch.float32
    assert _rel(got[name], want[name]) <= 1e-5
    if name == "latents":
        assert tuple(got[name].shape) == (1, 16, 4, 8, 8)


def test_decode_of_the_denoised_latent_matches_jax(runs):
    got, want = runs
    d = np.abs(got["video"].numpy() - np.asarray(want["video"]))
    assert d.max() <= 2 ** -3 and d.mean() <= 2 ** -6
    out, wout = got["out"], want["out"]
    agree = torch.from_numpy(np.array(wout.conf_valid_mask)) \
        == out.conf_valid_mask
    assert agree.float().mean() >= 0.999
    for a, b in ((out.gaussians.means, wout.gaussians.means),
                 (out.depth, wout.depth),
                 (out.extrinsic_c2w, wout.extrinsic_c2w),
                 (out.intrinsic_norm, wout.intrinsic_norm)):
        assert _rel(a, b) <= 1e-3


def test_text_to_3dgs_writes_what_the_user_gets(slices, runs, tmp_path,
                                              monkeypatch):
    """The port's whole request on the CPU: both mp4s and the PLY, each
    stage of `pipelines/t23d.py` and `io/video_export.py` a span, in order,
    a `unipc.step` span a step around its `dit.forward`, each span a
    profiler range of its name (which `chip_smoke.py` and the benchmark's
    breakdown read), no kernel launch."""
    _, modules, z = slices
    _, tcfg = _configs()
    ranges = []
    record_function = tprof.record_function

    def record(name):
        ranges.append(name)
        return record_function(name)

    monkeypatch.setattr(tprof, "record_function", record)
    monkeypatch.setattr(tprof, "RECORDER", tprof.SpanRecorder())
    fa.reset_launch_counts()
    res = tt.text_to_3dgs(modules, tokenize, PROMPT, str(tmp_path / "scene"),
                          tcfg, latents0=torch.from_numpy(z), orbit_t=0,
                          device="cpu")
    got = tprof.spans()
    assert sorted(ranges) == sorted(s.name for s in got)
    assert [n for n in ranges if n not in ("unipc.step", "dit.forward")
            and not n.startswith("render.")] == [
        "t23d.embed", "t23d.denoise", "decode.vae", "decode.resize",
        "decode.stitched", "export.cameras", "export.render",
        "export.frames_to_host", "export.colour_uint8", "export.turbo_uint8",
        "export.mp4_write", "export.ply"]
    steps = [s for s in got if s.name == "unipc.step"]
    fwds = [s for s in got if s.name == "dit.forward"]
    assert len(steps) == len(fwds) == tcfg.num_inference_steps
    assert all(s.start_ns <= f.start_ns <= f.end_ns <= s.end_ns
               for s, f in zip(steps, fwds))
    assert fa.launches_natural == 0
    torch.testing.assert_close(res.latents, runs[0]["latents"], rtol=0,
                               atol=0)
    arts = res.artifacts
    assert arts.color.shape == (13, 3, 56, 56)
    assert np.isfinite(arts.color).all() and np.isfinite(arts.depth).all()
    assert os.path.getsize(arts.gs_path) > 0
    assert os.path.getsize(arts.depth_path) > 0
    ply = tply.load_ply(arts.ply_path)
    assert len(ply["x"]) == 13 * 56 * 56
    np.testing.assert_array_equal(ply["x"],
                                  res.output.gaussians.means[0, :, 0].numpy())


def test_denoise_draws_its_noise_from_the_seed(slices):
    """Without `latents0`, the noise is a torch generator draw seeded with
    `cfg.seed`: the same seed gives the same latents, another seed others."""
    _, modules, _ = slices
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, num_inference_steps=1)
    cond, uncond = tt.embed_prompts(modules["umt5"], tokenize, PROMPT,
                                    device="cpu")
    a = tt.denoise(modules["dit"], cond, uncond, tcfg, device="cpu")
    b = tt.denoise(modules["dit"], cond, uncond, tcfg, device="cpu")
    c = tt.denoise(modules["dit"], cond, uncond,
                   dataclasses.replace(tcfg, seed=tcfg.seed + 1),
                   device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tt.ORBIT_PROMPT_TEMPLATE == jt.ORBIT_PROMPT_TEMPLATE
    assert tt.NEGATIVE_PROMPT == jt.NEGATIVE_PROMPT
