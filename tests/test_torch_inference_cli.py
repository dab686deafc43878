"""The text→3DGS command line of the port (`cli/arguments.py`,
`cli/model_loading.py`, `cli/inference_t23d.py`) against the JAX package's.

  * `load_stitched_model` on a weights root of reference-format files (the
    tiny encoder of `test_torch_slice.py` and a tiny Wan VAE with random
    weights from a seed, written through the port's fabricators; a
    stitched checkpoint
    chopped at 2 with LoRA r2 α4 on every site and bias="lora_only"),
    against JAX `load_stitched_model` followed by `convert`, both packages'
    configs monkeypatched to the tiny ones and the deployed-manifest gate
    off (the tiny files are not the deployed ones; the gate is
    `test_torch_weight_import.py`'s).  Tolerances: a LoRA-merged weight
    within 1e-6 of the weight's largest magnitude in fp32 (the merge's
    matmul sums in each library's order), within one bf16 step (2⁻⁸
    relative) after the bf16 cast; everything else exactly.
  * `main` end to end on the CPU at tiny sizes: the same code path as
    phase `cli` of `chip_smoke.py` (its `drive_cli`: the reference-format
    files written by its own safetensors writer, UMT5 in bf16, the main
    with the reference's flags on two prompts, then every imported
    parameter held bit for bit against what was written, merged where LoRA
    was), 5 frames, 2 UniPC steps and no orbit in-betweens.
  * `run`'s sharding `prompts[rank::world]` and folder names, and the
    flag names and defaults of every parser against the JAX package's.
"""

import argparse
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository's root script)
from test_torch_slice import CAMERA_BIAS, _configs
from vist3a_tpu.cli import arguments as jarg
from vist3a_tpu.cli import model_loading as jml
from vist3a_tpu.nn import wan_vae as jvae
from vist3a_tpu.stitch.conv_spec import parse_conv_spec as jparse
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.cli import arguments as targ
from vist3a_tpu_torch.cli import inference_t23d as tinf
from vist3a_tpu_torch.cli import model_loading as tml
from vist3a_tpu_torch.io import manifests as tmf
from vist3a_tpu_torch.io.load_weights import load_safetensors
from vist3a_tpu_torch.nn import umt5 as tumt5
from vist3a_tpu_torch.nn import wan_dit as tdit
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.nn.encoder import Encoder, cast_trunk_bf16
from vist3a_tpu_torch.nn.layers import build_random
from vist3a_tpu_torch.pipelines import t23d as tt
from vist3a_tpu_torch.stitch import chopped_anysplat as tca
from vist3a_tpu_torch.stitch.lora import parse_lora_mode

safetensors_torch = pytest.importorskip("safetensors.torch")

VAE = dict(base_dim=8, z_dim=16, num_res_blocks=1)
UMT5 = dict(vocab_size=64, d_model=40, d_kv=10, num_heads=4, d_ff=64,
            num_layers=2, max_sequence_length=32)
DIT = dict(dim=48, ffn_dim=96, num_layers=2, num_heads=4, freq_dim=32,
           text_dim=40)
LORA = "r2,a4,d0.0,f0"
MERGE_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(root, tcfg, lora=LORA):
    return ["--checkpoint_path", str(root / "anysplat_stitched.pth"),
            "--transformer_lora_path", str(root / "wan_lora"),
            "--input_texts_path", str(root / "prompts.txt"),
            "--stitching_layer_location",
            f"enc_blocks_{tcfg.stitch_layer_index}",
            "--stitching_layer_config", tcfg.conv_spec,
            "--lora_config", lora]


@pytest.fixture
def tiny_gate_off(monkeypatch):
    """Both packages' loaders at the tiny configs, the deployed-manifest
    gate off."""
    jcfg, tcfg = _configs()
    monkeypatch.setattr(tmf, "validate_state_dict", lambda sd, f, **k: True)
    monkeypatch.setattr(tmf, "validate_wan_dit", lambda sd: sd)
    monkeypatch.setattr(tml, "EncoderConfig", lambda: tcfg.encoder)
    monkeypatch.setattr(tml, "WanVAEConfig",
                        lambda: tvae.WanVAEConfig(**VAE))
    monkeypatch.setattr(jml, "_validate", lambda sd, family: sd)
    monkeypatch.setattr(jvae, "WanVAEConfig",
                        functools.partial(jvae.WanVAEConfig, **VAE))
    return jcfg, tcfg


@pytest.mark.parametrize("bf16", [False, True])
def test_load_stitched_model_matches_jax(tiny_gate_off, tmp_path, bf16):
    _, tcfg = tiny_gate_off
    gen = torch.Generator().manual_seed(0)
    enc = build_random(lambda: Encoder(tcfg.encoder), gen, "cpu",
                       torch.float32)
    vcfg = tvae.WanVAEConfig(**VAE)
    halves = [tvae.init_encoder(vcfg, gen, device="cpu"),
              tvae.init_decoder(vcfg, gen, device="cpu")]
    torch.save(tmf._fab_anysplat_encoder(enc), tmp_path / "anysplat.pth")
    (tmp_path / "wan_vae").mkdir()
    safetensors_torch.save_file(
        {k: v.contiguous() for k, v in tmf._fab_wan_vae(*halves).items()},
        tmp_path / "wan_vae" / "diffusion_pytorch_model.safetensors")
    ck, factors, _ = chip_smoke.stitched_checkpoint(
        enc, tcfg, parse_lora_mode(LORA), torch.Generator().manual_seed(3))
    torch.save(ck, tmp_path / "anysplat_stitched.pth")

    jargs = jarg.inference_vist3a_argument().parse_args(_flags(tmp_path,
                                                               tcfg))
    jargs.weights_root = str(tmp_path)
    jp, jscfg = jml.load_stitched_model(jargs, eval_dtype_bf16=bf16)
    targs = targ.inference_vist3a_argument().parse_args(
        _flags(tmp_path, tcfg) + ["--weights_root", str(tmp_path)])
    modules, scfg = tml.load_stitched_model(targs, eval_dtype_bf16=bf16,
                                            device="cpu")
    assert scfg == tcfg and jscfg.stitch_layer_index == 2

    ref = tca.StitchedDecoder(tcfg)
    if bf16:
        cast_trunk_bf16(ref.encoder)
    want = convert.load_jax_params(
        ref, {"encoder": jp["encoder"], "stitch_conv": jp["stitch_conv"]}
    ).state_dict()
    got = modules["stitched"].state_dict()
    assert got.keys() == want.keys()
    merged = {f"encoder.{s}.weight" for s in factors}
    assert merged and all(k in got for k in merged)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if k in merged:
            w32, g32 = w.float(), g.float()
            scale = float(w32.abs().max())
            tol = MERGE_RTOL * scale if w.dtype == torch.float32 \
                else 2 ** -8 * float(w32.abs().max())
            assert float((g32 - w32).abs().max()) <= tol, k
        else:
            assert torch.equal(g, w), k
    dt = torch.bfloat16 if bf16 else torch.float32
    assert sorted(modules) == ["stitched", "vae"]
    halves = tml.load_wan_vae(tmp_path, vcfg, device="cpu", dtype=dt)
    for got, mod in ((modules["vae"], tvae.WanVAEDecoder),
                     (halves["encoder"], tvae.WanVAEEncoder),
                     (halves["decoder"], tvae.WanVAEDecoder)):
        ref = convert.load_jax_vae_params(mod(vcfg), jp["vae"]) \
            .to(dt).state_dict()
        got = got.state_dict()
        assert got.keys() == ref.keys()
        assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_main_on_reference_files_at_tiny_sizes(tiny_gate_off, tmp_path,
                                               monkeypatch):
    """`chip_smoke.drive_cli`, phase `cli`'s own code, on the CPU."""
    _, tcfg = tiny_gate_off
    ucfg, dcfg = tumt5.UMT5Config(**UMT5), tdit.WanDiTConfig(**DIT)
    vcfg = tvae.WanVAEConfig(**VAE)
    monkeypatch.setattr(tumt5, "UMT5_XXL", ucfg)
    monkeypatch.setattr(tdit, "config_from_model_id", lambda m: dcfg)
    monkeypatch.setattr(tt, "T23DConfig", functools.partial(
        tt.T23DConfig, width=64, height=64, num_inference_steps=2,
        feedforward_size=56, vae=vcfg, umt5=ucfg))
    request = tt.text_to_3dgs
    monkeypatch.setattr(tt, "text_to_3dgs", lambda *a, **k: request(
        *a, **{**k, "orbit_t": 0}))
    gen = torch.Generator().manual_seed(7)
    src = {"encoder": build_random(lambda: Encoder(tcfg.encoder), gen,
                                   "cpu", torch.float32),
           "vae_encoder": tvae.init_encoder(vcfg, gen, device="cpu"),
           "vae_decoder": tvae.init_decoder(vcfg, gen, device="cpu"),
           "umt5": tumt5.init(ucfg, gen, "cpu", torch.bfloat16),
           "dit": tdit.init(dcfg, gen, "cpu", torch.bfloat16)}
    src["encoder"].camera_head.pose_branch.fc2.bias.copy_(
        torch.from_numpy(CAMERA_BIAS))
    res = chip_smoke.drive_cli(src, tcfg, LORA, tmp_path,
                               tokenize=chip_smoke.fake_tokenizer(ucfg),
                               device="cpu", flags=("--num_frames", "5"))
    assert [p for p, _ in res["results"]] == list(chip_smoke.CLI_PROMPTS)
    assert _tensors_in(res["results"]) == []
    assert "/" in chip_smoke.CLI_PROMPTS[1]
    assert res["compared"]["stitched"] > 100
    assert res["merged_sites"]["stitched"] > 50
    assert res["merged_sites"]["dit"] == DIT["num_layers"] * 2 * 4
    assert res["bytes"]["umt5"] > 0 and len(res["request_s"]) == 2
    assert sorted(p.name for p in (tmp_path / "weights" / "umt5").iterdir()) \
        == ["model-00001-of-00003.safetensors",
            "model-00002-of-00003.safetensors",
            "model-00003-of-00003.safetensors", "model.safetensors.index.json"]
    # the writer's files are what the safetensors package reads
    shard = tmp_path / "weights" / "umt5" / "model-00001-of-00003.safetensors"
    theirs = safetensors_torch.load_file(shard)
    mine = load_safetensors(shard)
    assert theirs.keys() == mine.keys()
    assert all(theirs[k].dtype == torch.bfloat16
               and torch.equal(theirs[k], mine[k]) for k in theirs)


@pytest.mark.parametrize("dit_dtype", [torch.bfloat16, torch.float32])
def test_cli14b_on_files_at_tiny_sizes(tiny_gate_off, tmp_path,
                                      monkeypatch, dit_dtype):
    """Phase `cli14b`'s own code on the CPU (`chip_smoke.drive_cli14b`,
    `drive_point_decode`): phase `cli`'s files without the DiT, then a DiT
    written part by part in bf16 or fp32, loaded under the 14B model id
    (the tiny config in its place), one request, the DiT held bit for bit
    and its merged sites within half a bf16 spacing of the float64 merge
    (an fp32 file merged after a cast to bf16 is a spacing off), the
    validation views and their PNG, and the point-head decode from the
    file with the point head added."""
    _, tcfg = tiny_gate_off
    point_cfg = dataclasses.replace(
        tcfg.encoder.depth, activation="inv_log", output_dim=4)
    ecfg = dataclasses.replace(tcfg.encoder, point=point_cfg)
    monkeypatch.setattr(tml, "EncoderConfig", lambda: ecfg)
    ucfg, dcfg = tumt5.UMT5Config(**UMT5), tdit.WanDiTConfig(**DIT)
    vcfg = tvae.WanVAEConfig(**VAE)
    monkeypatch.setattr(tumt5, "UMT5_XXL", ucfg)
    monkeypatch.setattr(tdit, "config_from_model_id", lambda m: dcfg)
    monkeypatch.setattr(tt, "T23DConfig", functools.partial(
        tt.T23DConfig, width=64, height=64, feedforward_size=56, vae=vcfg,
        umt5=ucfg))
    request = tt.text_to_3dgs
    monkeypatch.setattr(tt, "text_to_3dgs", lambda *a, **k: request(
        *a, **{**k, "orbit_t": 0}))
    gen = torch.Generator().manual_seed(7)
    src = {"encoder": build_random(lambda: Encoder(tcfg.encoder), gen,
                                   "cpu", torch.float32),
           "vae_encoder": tvae.init_encoder(vcfg, gen, device="cpu"),
           "vae_decoder": tvae.init_decoder(vcfg, gen, device="cpu"),
           "umt5": tumt5.init(ucfg, gen, "cpu", torch.bfloat16)}
    src["encoder"].camera_head.pose_branch.fc2.bias.copy_(
        torch.from_numpy(CAMERA_BIAS))
    base = tmp_path / "base"
    base.mkdir()
    chip_smoke.write_weights_root(base, src, tcfg, parse_lora_mode(LORA),
                                  torch.Generator().manual_seed(21))
    assert sorted(p.name for p in base.iterdir()) == [
        "anysplat.pth", "anysplat_stitched.pth", "umt5", "wan_vae"]
    res = chip_smoke.drive_cli14b(
        base, tmp_path, tcfg, tokenize=chip_smoke.fake_tokenizer(ucfg),
        device="cpu", steps=2, point_cfg=point_cfg, flags=(
            "--num_frames", "5"),
        viz_sizes={"views": 24, "image": 32, "trajectory": 6},
        dit_dtype=dit_dtype)
    (prompt, summary), = res["results"]
    assert prompt == chip_smoke.CLI14B_PROMPT and summary["latents_finite"]
    assert _tensors_in(res["results"]) == []
    assert res["compared"]["dit"] == len(tdit.init(dcfg, gen, "cpu")
                                         .state_dict())
    assert res["merged_sites"] == DIT["num_layers"] * 2 * 4
    assert res["dit_site_err_share"] <= 1
    shards = sorted((tmp_path / "weights" / "wan_dit").iterdir())
    assert len(shards) == DIT["num_layers"] + 2          # and the index
    assert res["stages_s"].keys() == set(chip_smoke.T23D_REQUEST_STAGES)
    assert res["launches"] == {"unmasked": 0, "masked": 0, "natural": 0,
                               "composite": 0, "qk_prologue": 0}
    views = res["views"]
    assert views["projections"][:3] == [1, 3, 3]
    assert views["trajectory"] == [6, 3, 32, 32]
    assert views["png_bytes"] > 0
    assert {"write.dit", "load.generator", "request", "viz.projections",
            "viz.layout", "check.dit"} <= res["times"].keys()
    point = chip_smoke.drive_point_decode(res["args"], res["point"],
                                          device="cpu", frames=5, image=56,
                                          latent_hw=8)
    assert point["summary"]["point_head_tensors"] == len(res["point"]) > 0
    assert point["summary"]["live"] > 0


def test_sweep_stale_shards_removes_only_ended_runs(tmp_path):
    """Phase `cli14b`'s shard folders of a process that has ended are
    removed; those of a live process and other folders stay."""
    ended = subprocess.Popen([sys.executable, "-c", "pass"])
    ended.wait()
    prefix = chip_smoke.CLI14B_SHARD_PREFIX
    for name in (f"{prefix}{ended.pid}_a", f"{prefix}{os.getpid()}_b",
                 f"{prefix}x_c", "other"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "shard").write_bytes(b"0")
    assert chip_smoke.sweep_stale_shards(tmp_path) == [
        f"{prefix}{ended.pid}_a"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([
        f"{prefix}{os.getpid()}_b", f"{prefix}x_c", "other"])


def test_run_shards_prompts_and_names_folders(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tt, "text_to_3dgs", lambda modules, tok, prompt,
                        save, cfg, **kw: calls.append((prompt, save, kw))
                        or prompt.upper())
    monkeypatch.setattr(tinf, "summarize", lambda res: {"of": res})
    prompts = ["a / b", "x" * 150, "third", "fourth"]
    out = tinf.run({}, None, prompts, str(tmp_path), tt.T23DConfig(),
                   process_index=1, process_count=2, device="cpu")
    assert out == [(p, {"of": p.upper()}) for p in prompts[1::2]]
    assert [c[0] for c in calls] == prompts[1::2]
    assert calls[0][1] == str(tmp_path / ("x" * 100))
    assert calls[0][2] == {"orbit_t": 10, "device": "cpu"}
    assert (tmp_path / ("x" * 100) / "prompt.txt").read_text() == "x" * 150
    tinf.run({}, None, prompts[:1], str(tmp_path), tt.T23DConfig(),
             device="cpu")
    assert (tmp_path / "a  b" / "prompt.txt").read_text() == "a / b"
    assert tt.T23DConfig().seed == 12413
    from vist3a_tpu_torch.core import distributed
    assert (distributed.get_rank(), distributed.get_world_size()) == (0, 1)


def _tensors_in(tree) -> list:
    """Every torch.Tensor anywhere in nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors_in(x)]
    return []


def _fake_result(save: str, g: int = 6, s: int = 2) -> tt.T23DResult:
    """A `T23DResult` of small tensors, its files named under `save`."""
    import numpy as np

    from vist3a_tpu_torch.nn.encoder import EncoderOutput
    from vist3a_tpu_torch.nn.gaussians import Gaussians

    gauss = Gaussians(torch.zeros(1, g, 3), torch.zeros(1, g, 3, 3),
                      torch.zeros(1, g, 3, 25), torch.ones(1, g),
                      torch.ones(1, g, 3), torch.zeros(1, g, 4))
    out = EncoderOutput(gauss, [], torch.eye(4).expand(1, s, 4, 4),
                        torch.eye(3).expand(1, s, 3, 3),
                        torch.ones(1, s, 4, 4, 1), torch.ones(1, s, 4, 4),
                        torch.ones(1, s, 4, 4, dtype=torch.bool),
                        torch.ones(()), torch.zeros(1, s, 4, 4, 8),
                        torch.ones(1, g))
    arts = tt.Artifacts(f"{save}/gs.mp4", f"{save}/depth.mp4",
                        f"{save}/gaussians.ply",
                        np.full((3, 3, 4, 4), 0.25, np.float32),
                        np.ones((3, 4, 4), np.float32))
    return tt.T23DResult(torch.zeros(1, 16, 2, 4, 4), out, arts)


def test_run_keeps_no_tensor(tmp_path, monkeypatch):
    """`run` keeps, of each request, its paths and a host summary: no
    tensor on any device (a scene holds ~1 GB on the card at full width),
    as the JAX `run` keeps only (prompt, paths)."""
    monkeypatch.setattr(tt, "text_to_3dgs", lambda modules, tok, prompt,
                        save, cfg, **kw: _fake_result(save))
    out = tinf.run({}, None, ["a", "b / c"], str(tmp_path), tt.T23DConfig(),
                   device="cpu")
    assert [p for p, _ in out] == ["a", "b / c"]
    assert _tensors_in(out) == []
    s = out[1][1]
    assert s["paths"]["ply"] == str(tmp_path / "b  c" / "gaussians.ply")
    assert s["latents_shape"] == (1, 16, 2, 4, 4) and s["latents_finite"]
    assert s["shapes"]["means"] == (1, 6, 3) and all(s["finite"].values())
    assert s["frames_shape"] == (3, 3, 4, 4) and s["frames_mean"] == 0.25
    assert s["frames_range"] == (0.25, 0.25) and s["depth_finite"]


PARSERS = ("stitching_training_argument", "find_layer_stitching_argument",
           "stitching_nvs_evaluation_argument", "training_vdm_argument",
           "inference_vist3a_argument")


def _flag_table(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required,
                     a.choices, a.nargs, type(a).__name__)
            for a in parser._actions}


@pytest.mark.parametrize("name", PARSERS)
def test_flags_and_defaults_are_the_jax_parsers(name):
    mine = _flag_table(getattr(targ, name)())
    theirs = _flag_table(getattr(jarg, name)())
    if name == "inference_vist3a_argument":
        extra = mine.pop("weights_root")           # the port's one addition
        assert extra[:3] == (("--weights_root",), None, False)
    assert mine == theirs
    # the mesh flags parse as JAX's (a layout is held against the world
    # size by `core/mesh.py`, not by the parser)
    argv = ["--mesh_data", "4", "--mesh_model", "2"]
    if "mesh_model" in mine:
        required = {"inference_vist3a_argument": [
            "--checkpoint_path", "c", "--transformer_lora_path", "l",
            "--input_texts_path", "p"]}.get(name, [])
        a = getattr(targ, name)().parse_args(argv + required)
        b = getattr(jarg, name)().parse_args(argv + required)
        assert (a.mesh_data, a.mesh_model) == (b.mesh_data, b.mesh_model) \
            == (4, 2)
        assert getattr(a, "dit_sharding", None) == \
            getattr(b, "dit_sharding", None)
    else:
        with pytest.raises(SystemExit):
            getattr(targ, name)().parse_args(["-x"])


def test_inference_defaults_and_the_one_device_mesh(tmp_path):
    args = targ.inference_vist3a_argument().parse_args(
        ["--checkpoint_path", "c", "--transformer_lora_path", "l",
         "--input_texts_path", "p", "--mesh_data", "-1", "--mesh_model", "1"])
    assert (args.num_frames, args.flow_shift, args.cfg_scale,
            args.model_id) == (13, 5, "7.5",
                               "Wan-AI/Wan2.1-T2V-1.3B-Diffusers")
    assert dataclasses.asdict(args.stitching_layer_config) == \
        dataclasses.asdict(jparse("conv3d_k5x3x3_o1024_s1x2x2_p2x1x1"))
    assert tml.weights_root(args) == tml.weights_root(None)
    assert tml.weights_root(argparse.Namespace(weights_root=str(tmp_path))) \
        == tmp_path
