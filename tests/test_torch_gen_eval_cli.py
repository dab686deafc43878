"""The port's `cli/gen_eval.py` against the JAX package's, and phase
`generation`'s own code (`chip_smoke.drive_generation`) on the CPU at tiny
sizes: run it here before spending a chip call on the phase.

  * the `t3` and `dpg` parsers: JAX's flags, destinations, defaults and
    required flags; `main` without a mode is a usage error;
  * `drive_generation` over two {prompt.txt, gs.mp4} folders with the
    phase's writers (`write_generation_root`: the Qwen2.5-VL judge at the
    tiny configs of `tests/test_qwen_vl.py` in fp32, HF CLIPModel folders
    of tiny CLIP and LongCLIP towers, the aesthetic probe, a MUSIQ-SPAQ
    npz) and `StandInQwenTokenizer`: every check of the phase;
  * the JAX package's `main_t3` and `main_dpg` on the same files and
    folders (its judge handed the same tokenizer): the t3 JSON within 1e-5
    relative, CLIPScore and LongCLIP within 1e-5 of their cosine (their
    100·cos: 1e-3 points; their inputs, `jax.image.resize` rebuilt, are
    within 1e-5 of JAX's, `tests/test_torch_scorers.py`), and the dpg JSON
    equal;
  * `chip_smoke.clip_cosines`, the cosines before the clamp that the phase
    holds card against host: clamped and averaged, the scorer's score.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_qwen_vl import TT, TV, one_torch_thread  # noqa: F401
from vist3a_tpu.cli import gen_eval as jcli
from vist3a_tpu.eval import qwen_judge as jjudge
from vist3a_tpu_torch.cli import gen_eval as tcli
from vist3a_tpu_torch.eval import gen_eval as tgen
from vist3a_tpu_torch.eval import scorers as tscorers
from vist3a_tpu_torch.io.video_export import to_uint8_frames, write_mp4
from vist3a_tpu_torch.nn import clip as tclip

# the chat template's specials in the tiny vocabulary, as
# `tests/test_qwen_judge.py::StubTokenizer` places them
TINY_SPECIALS = {"<|im_start|>": 100, "<|im_end|>": 101,
                 "<|image_pad|>": 120, "<|vision_start|>": 122,
                 "<|vision_end|>": 123}
PROMPTS = ("a red chair in a garden",
           "a wooden boat on a calm lake, seen from bow/stern")
TINY_CLIP = (
    tclip.CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=4,
                           mlp_dim=64, patch_size=8, image_size=32,
                           projection_dim=16, act="quick_gelu"),
    tclip.CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=4,
                         mlp_dim=64, vocab_size=1024, context_length=16,
                         projection_dim=16, act="quick_gelu"),
    tclip.CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=4,
                         mlp_dim=64, vocab_size=1024, context_length=24,
                         projection_dim=16, act="quick_gelu"))
T3_RTOL = 1e-5
# CLIPScore is 100·mean(max(cos, 0)): held on the cosine
T3_COS_ATOL = 1e-5


def _actions(parser):
    return sorted((a.dest, tuple(a.option_strings), a.default, a.required,
                   a.type) for a in parser._actions)


def test_flag_parsers_are_jax():
    assert _actions(tcli.t3_argument()) == _actions(jcli.t3_argument())
    assert _actions(tcli.dpg_argument()) == _actions(jcli.dpg_argument())


def test_usage_error():
    for argv in ([], ["t4"]):
        with pytest.raises(SystemExit):
            tcli.main(argv)


def test_tiny_judge_configs_are_the_tests():
    assert chip_smoke.tiny_judge_configs() == (TV, TT)


def tiny_tokenizer():
    return chip_smoke.StandInQwenTokenizer(TINY_SPECIALS, 90)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("generation")
    scenes = tmp / "scenes"
    for i, prompt in enumerate(PROMPTS):
        d = scenes / prompt[:100].replace("/", "")
        d.mkdir(parents=True)
        frames = np.random.default_rng(i).random((5, 3, 32, 48)).astype(
            np.float32)
        write_mp4(to_uint8_frames(frames), d / "gs.mp4", fps=5)
        (d / "prompt.txt").write_text(prompt)
    src = chip_smoke.build_generation_sources(
        "cpu", judge=(TV, TT), clip_cfgs=TINY_CLIP, judge_dtype=torch.float32)
    res = chip_smoke.drive_generation(src, tmp, scenes, device="cpu",
                                      tokenizer=tiny_tokenizer(),
                                      num_frames=2, dpg_frames=1,
                                      ur_tokens=4)
    return tmp, scenes, res


def test_generation_on_files_at_tiny_sizes(generated):
    _, _, res = generated
    assert [r["prompt"] for r in res["t3"]["per_prompt"]] == sorted(PROMPTS)
    assert len(res["answers"]) == len(PROMPTS) * 3
    assert set(res["answers"]) <= {"Yes", "No"}
    assert res["unified_reward"]["decode_steps"] == 4
    assert res["dpg_judge"]["calls"] == len(PROMPTS) * 3
    assert set(res["scorer_s"]) == {"clip", "longclip", "aesthetic",
                                    "musiq"}
    assert all(v == 0 for c in res["launches"].values()
               for v in c.values())


@pytest.mark.parametrize("which", ["clip", "longclip"])
def test_clip_cosines_are_the_scorers(generated, monkeypatch, which):
    """`chip_smoke.clip_cosines`, which phase `generation` compares card
    against host, gives the scorer's score once clamped at 0 and
    averaged."""
    tmp, scenes, _ = generated
    towers = []
    make = tscorers.make_clip_scorer

    def keeping(vision, text_fn):
        towers.append((vision, text_fn))
        return make(vision, text_fn)
    monkeypatch.setattr(tscorers, "make_clip_scorer", keeping)
    score, _ = tcli._load_clip_scorer(str(tmp / "weights" / which),
                                      device="cpu")
    folder, prompt = tgen.discover_prompt_folders(scenes)[0]
    frames = tgen.sample_video_frames(folder / "gs.mp4", 2)
    cos = chip_smoke.clip_cosines(*towers[0], frames, prompt)
    assert cos.shape == (2,)
    assert score(frames, prompt) == pytest.approx(
        100.0 * np.maximum(cos, 0.0).mean(), rel=1e-6, abs=1e-6)


def test_t3_main_matches_jax(generated):
    tmp, scenes, res = generated
    root = tmp / "weights"
    args = jcli.t3_argument().parse_args([
        "--folder_path", str(scenes), "--eval_save_path",
        str(tmp / "jax_t3.json"), "--num_frames", "2",
        "--clip_path", str(root / "clip"),
        "--longclip_path", str(root / "longclip"),
        "--aesthetic_probe", str(root / "aesthetic.npy"),
        "--musiq_weights", str(root / "musiq.npz")])
    want = jcli.main_t3(args)
    got = res["t3"]
    assert len(got["per_prompt"]) == len(want["per_prompt"])
    for g, w in zip(got["per_prompt"] + [got["summary"]],
                    want["per_prompt"] + [want["summary"]]):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k in ("clip", "longclip"):
                assert abs(g[k] - v) <= 100 * T3_COS_ATOL, k
            elif isinstance(v, float):
                assert abs(g[k] - v) <= T3_RTOL * abs(v), k
            else:
                assert g[k] == v


def test_dpg_main_matches_jax(generated, monkeypatch):
    tmp, scenes, res = generated
    orig = jjudge.load_judge
    monkeypatch.setattr(jjudge, "load_judge", lambda path, **kw: orig(
        path, tokenizer=tiny_tokenizer()))
    args = jcli.dpg_argument().parse_args([
        "--folder_path", str(scenes), "--csv", str(tmp / "dpg.csv"),
        "--res_path", str(tmp / "jax_dpg.json"), "--num_frames", "1",
        "--model-path", str(tmp / "weights" / "judge")])
    want = jcli.main_dpg(args)
    assert res["dpg"] == want
    assert json.loads((tmp / "results" / "dpg.json").read_text()) == want
