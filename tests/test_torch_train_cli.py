"""The workflows' command lines of the port (`cli/find_layer.py::main`,
`cli/train_stitching.py::main`, `cli/train_vdm.py::main`) and the parts of
the trainers' loops the JAX package's have (`set_epoch`, the stream
position, the VDM image grid and `history.jsonl`).

  * `chip_smoke.drive_workflows`, phase `workflows`' own code, on the CPU
    at the tiny configs of `tests/test_torch_slice.py` /
    `tests/test_torch_inference_cli.py` (both packages' deployed-manifest
    gate off, as there): the reference-format files written by the
    script's own writers (the scorers through the port's fabricators, a
    synthetic CLIP vocabulary), synthetic DL3DV / ScanNet trees written
    with OpenCV, then the search (twice: the second from the cache), the
    distillation from the search's artifact (3 steps) and one VDM step,
    with every check of the phase but the launch counts.
  * The loops: `run` of both trainers calls the sampler's `set_epoch`
    with the epoch the step count gives and skips the consumed batches
    (the counterpart of `test_run_resume_restores_stream_position`).
  * The image grid equals the JAX `_save_image_grid`'s pixel for pixel,
    written by imageio and by OpenCV; a step's history record holds the
    keys of the JAX `run`'s.
"""

import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository's root script)
from test_torch_inference_cli import DIT, UMT5, VAE  # noqa: E402
from test_torch_slice import CAMERA_BIAS, _configs  # noqa: E402
from vist3a_tpu.cli import train_vdm as jvdm_cli  # noqa: E402
from vist3a_tpu_torch.cli import model_loading as tml  # noqa: E402
from vist3a_tpu_torch.cli import train_stitching as tstc  # noqa: E402
from vist3a_tpu_torch.cli import train_vdm as tvdm_cli  # noqa: E402
from vist3a_tpu_torch.io import manifests as tmf  # noqa: E402
from vist3a_tpu_torch.nn import clip as tclip  # noqa: E402
from vist3a_tpu_torch.nn import umt5 as tumt5  # noqa: E402
from vist3a_tpu_torch.nn import wan_dit as tdit  # noqa: E402
from vist3a_tpu_torch.nn import wan_vae as tvae  # noqa: E402
from vist3a_tpu_torch.nn.encoder import Encoder  # noqa: E402
from vist3a_tpu_torch.nn.layers import build_random  # noqa: E402
from vist3a_tpu_torch.stitch.chopped_anysplat import (  # noqa: E402
    init_stitch_conv)
from vist3a_tpu_torch.train import reward as trew  # noqa: E402
from vist3a_tpu_torch.train import stitching as tst  # noqa: E402
from vist3a_tpu_torch.train import vdm as tvdm  # noqa: E402

CLIP_VIS = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
                patch_size=8, image_size=32, projection_dim=16)
CLIP_TXT = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
                vocab_size=1024, context_length=16, projection_dim=16)
SIZES = ("--resolution", "64", "--feedforward_resolution", "56",
         "--num_images_from_unit_scene", "5")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_workflows_on_files_at_tiny_sizes(tmp_path, monkeypatch):
    _, tcfg = _configs()
    ucfg, dcfg = tumt5.UMT5Config(**UMT5), tdit.WanDiTConfig(**DIT)
    vcfg = tvae.WanVAEConfig(**VAE)
    vis, txt = tclip.CLIPVisionConfig(**CLIP_VIS), \
        tclip.CLIPTextConfig(**CLIP_TXT)
    monkeypatch.setattr(tmf, "validate_state_dict", lambda sd, f, **k: True)
    monkeypatch.setattr(tmf, "validate_wan_dit", lambda sd: sd)
    monkeypatch.setattr(tml, "EncoderConfig", lambda: tcfg.encoder)
    monkeypatch.setattr(tml, "WanVAEConfig", lambda: vcfg)
    monkeypatch.setattr(tumt5, "UMT5_XXL", ucfg)
    monkeypatch.setattr(tdit, "config_from_model_id", lambda m: dcfg)
    monkeypatch.setattr(trew, "RewardConfig", functools.partial(
        trew.RewardConfig, pick_cfg=vis, pe_cfg=vis))
    monkeypatch.setattr(tclip, "CLIP_H_TEXT", txt)
    monkeypatch.setattr(tvdm_cli, "run", functools.partial(
        tvdm_cli.run, latent_shape=(1, 16, 2, 8, 8), render_size=56))
    gen = torch.Generator().manual_seed(7)
    src = {"encoder": build_random(lambda: Encoder(tcfg.encoder), gen,
                                   "cpu", torch.float32),
           "vae_encoder": tvae.init_encoder(vcfg, gen, device="cpu"),
           "vae_decoder": tvae.init_decoder(vcfg, gen, device="cpu"),
           "umt5": tumt5.init(ucfg, gen, "cpu", torch.bfloat16),
           "dit": tdit.init(dcfg, gen, "cpu", torch.bfloat16),
           "pick_vision": tclip.init(vis, gen, "cpu"),
           "pick_text": tclip.text_init(txt, gen, "cpu"),
           "pe_vision": tclip.init(vis, gen, "cpu"),
           "pe_text": tclip.text_init(txt, gen, "cpu")}
    src["encoder"].camera_head.pose_branch.fc2.bias.copy_(
        torch.from_numpy(CAMERA_BIAS))
    res = chip_smoke.drive_workflows(
        src, tcfg, tmp_path, tokenize=chip_smoke.fake_tokenizer(ucfg),
        device="cpu",
        scene_kw=dict(hw=(48, 80), scannet_hw=(48, 64)),
        search_flags=SIZES + ("--num_frames_per_unit_scene", "5"),
        stitch_flags=SIZES + ("--num_frames_per_unit_scene", "5",
                              "--warmup_steps", "1"),
        vdm_flags=SIZES, grid_tiles=(1, 6))
    search = res["search"]
    assert len(search["mses"]) == tcfg.encoder.vit.depth
    assert search["cache_bytes"] > 0
    assert res["bytes"]["pickscore"] > 0 and res["bytes"]["dfn5b"] > 0
    assert [h["step"] for h in res["distillation"]["history"]] == [0]
    assert res["vdm"]["history"][0]["num_steps"] == 50


class _Sampler:
    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def set_epoch(self, epoch):
        self.calls.append((self.name, epoch))


def test_stitching_run_sets_the_epoch(tmp_path):
    """`run` calls `sampler.set_epoch(epoch)` at the start of every epoch
    (`vist3a_tpu/cli/train_stitching.py:71`), resumed epochs included."""
    _, tcfg = _configs()
    gen = torch.Generator().manual_seed(0)
    params = {"encoder": build_random(lambda: Encoder(tcfg.encoder), gen,
                                      "cpu", torch.float32),
              "stitch_conv": build_random(
                  lambda: init_stitch_conv(tcfg), gen, "cpu",
                  torch.float32),
              "vae": tvae.init_encoder(tvae.WanVAEConfig(**VAE), gen,
                                       device="cpu")}
    cfg = tst.StitchTrainConfig(lora_spec="r2,a4,d0.0,f0")
    calls = []
    state, history = tstc.run(params, tcfg, [], _Sampler(calls, "s"),
                              train_cfg=cfg, num_epochs=3,
                              save_path=tmp_path)
    assert calls == [("s", 0), ("s", 1), ("s", 2)] and history == []
    calls.clear()
    tstc.run(params, tcfg, [], _Sampler(calls, "s"), train_cfg=cfg,
             num_epochs=4, resume_path=tmp_path)
    assert calls == [("s", 3)]


def test_vdm_run_restores_the_stream_position():
    """At step N both loaders' samplers get epoch N // len and skip
    N mod len batches unloaded (`train_vdm.py:465-496`), as the JAX
    `run`."""
    calls = []

    class Loader:
        def __init__(self, name, n):
            self.sampler, self.name, self.n = _Sampler(calls, name), name, n

        def __len__(self):
            return self.n

        def __iter__(self):
            return iter([])

        def skip_first_batches(self, n):
            calls.append((self.name + "_skip", n))
            return self

    dit = types.SimpleNamespace(patch_embedding=types.SimpleNamespace(
        weight=torch.zeros(1)))
    state = tvdm.VDMTrainState(7, {}, None, {})
    tvdm_cli.run(state, dit, None, None, None,
                 text_loader=Loader("text", 3), video_loader=Loader("video", 5),
                 embed_text=None, reward_loss_fn=None, scfg=None,
                 cfg=tvdm.VDMTrainConfig(enable_rl=False), num_steps=7)
    assert sorted(calls) == [("text", 2), ("text_skip", 1), ("video", 1),
                             ("video_skip", 2)]


@pytest.mark.parametrize("writer", ["imageio", "cv2"])
def test_image_grid_matches_jax(tmp_path, monkeypatch, writer):
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    imgs = (rng.uniform(-0.1, 1.1, (1, 8, 8, 3)).astype(np.float32),
            rng.uniform(0, 1, (9, 8, 8, 3)).astype(np.float32))
    jvdm_cli._save_image_grid(tmp_path / "jax.png", imgs)
    if writer == "cv2":
        monkeypatch.setitem(sys.modules, "imageio", None)
    tvdm_cli._save_image_grid(tmp_path / "sub" / "torch.png", imgs)
    got = imageio.imread(tmp_path / "sub" / "torch.png")
    want = imageio.imread(tmp_path / "jax.png")
    assert got.shape == want.shape == (16, 56, 3)
    np.testing.assert_array_equal(got, want)


def test_history_keys_hold_the_jax_runs():
    """A step's record: the JAX `run`'s keys ("step", "prompt" and the
    step's float metrics), and the port's draws."""
    metrics = {"diffusion_loss": torch.tensor(0.5),
               "reward_loss": torch.tensor(0.25),
               "total_loss": torch.tensor(0.75),
               "grad_norm": torch.tensor(1.0), "skipped": False,
               "num_steps": 10, "backprop_idx": [1, 2, 9], "guidance": 5.0}
    calls = []

    def fake_step(state, *a, **kw):
        calls.append(kw["return_images"])
        state.step += 1
        return dict(metrics)
    dit = types.SimpleNamespace(patch_embedding=types.SimpleNamespace(
        weight=torch.zeros(1)))
    state = tvdm.VDMTrainState(0, {}, None, {})
    orig = tvdm.vdm_train_step
    tvdm.vdm_train_step = fake_step
    try:
        _, history = tvdm_cli.run(
            state, dit, None, None, None,
            text_loader=[{"prompt": ["p"]}] * 2,
            video_loader=[{"image_tensor": np.zeros((1, 3, 1, 2, 2),
                                                    np.float32),
                           "caption": ["c"]}],
            embed_text=lambda t: torch.zeros(len(t), 2, 4),
            reward_loss_fn=None, scfg=None,
            cfg=tvdm.VDMTrainConfig(enable_rl=False), num_steps=2)
    finally:
        tvdm.vdm_train_step = orig
    jax_keys = {"step", "prompt", "diffusion_loss", "reward_loss",
                "total_loss", "grad_norm", "skipped"}
    assert [h["step"] for h in history] == [1, 2] and calls == [False] * 2
    assert all(jax_keys <= h.keys() for h in history)
    assert history[0]["total_loss"] == 0.75
