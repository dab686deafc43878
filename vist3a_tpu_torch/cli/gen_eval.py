"""Entry point: generation-quality evaluation (SceneBench / T3 and
DPG-Bench).

Port of `vist3a_tpu/cli/gen_eval.py` (the reference's
`evaluation/gen_eval/t3_scene_evaluation.py:163-185` and
`dpg_evaluation.py:20-77`), with the same flags (`--folder_path`,
`--eval_save_path`, `--csv`, `--res_path`, `--model-path`, ...).  The
models load from LOCAL checkpoint folders:

  * `--model-path` → the Qwen2.5-VL judge (UnifiedReward and DPG's VQA),
    `eval/qwen_judge.py::load_judge`;
  * `--clip_path` / `--longclip_path` → HF CLIPModel folders (config.json,
    *.safetensors, vocab.json + merges.txt) for CLIPScore / LongCLIP;
  * `--aesthetic_probe` → a .npy holding {"weight", "bias"} of the LAION
    linear head (the CLIP-L vision tower comes from `--clip_path`);
  * `--musiq_weights` → MUSIQ-SPAQ weights (.npz, `eval/musiq.py`).

A scorer whose flag is omitted is skipped (the harness takes any
subset).

    python -m vist3a_tpu_torch.cli.gen_eval t3 --folder_path OUT \\
        --clip_path clip-vit-large-patch14 --longclip_path LongCLIP-L \\
        --aesthetic_probe aesthetic.npy --musiq_weights musiq_spaq.npz
    python -m vist3a_tpu_torch.cli.gen_eval dpg --folder_path OUT \\
        --csv dpg_bench.csv --model-path UnifiedReward-qwen-7b

`main(argv, tokenizer)` takes the judge's tokenizer where `transformers`
is absent.  Each main runs with TF32 off for cuBLAS and cuDNN (the scorers
in fp32 as the JAX package computes them).
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import json
from pathlib import Path

import torch


def t3_argument() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generation quality evaluation.")
    p.add_argument("--folder_path", type=str, required=True)
    p.add_argument("--eval_save_path", type=str, default="eval_results.json")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--model-path", dest="model_path", type=str, default=None,
                   help="local Qwen2.5-VL judge checkpoint dir")
    p.add_argument("--clip_path", type=str, default=None)
    p.add_argument("--longclip_path", type=str, default=None)
    p.add_argument("--aesthetic_probe", type=str, default=None)
    p.add_argument("--musiq_weights", type=str, default=None,
                   help="MUSIQ-SPAQ weights (.npz, eval.musiq layout)")
    return p


def dpg_argument() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DPG-Bench evaluation.")
    p.add_argument("--folder_path", type=str, required=True)
    p.add_argument("--csv", type=str, required=True)
    p.add_argument("--res_path", type=str, default="dpg_bench_results.json")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--model-path", dest="model_path", type=str, required=True)
    return p


def _load_judge_callables(model_path: str, *, tokenizer=None,
                          device: torch.device | str = "cuda"):
    from vist3a_tpu_torch.eval import qwen_judge

    vis, txt, tok, _, _ = qwen_judge.load_judge(model_path,
                                                tokenizer=tokenizer,
                                                device=device)
    return (qwen_judge.make_vqa_judge(vis, txt, tok),
            qwen_judge.make_unified_reward_judge(vis, txt, tok))


def _load_clip_scorer(path: str, *, device: torch.device | str = "cuda"):
    """An HF CLIPModel folder → (its CLIPScore scorer, its vision tower);
    the text context length (77, or 248 for LongCLIP) comes from its
    config."""
    from vist3a_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from vist3a_tpu_torch.eval import scorers
    from vist3a_tpu_torch.io.load_weights import load_sharded_safetensors
    from vist3a_tpu_torch.io.weight_import import build_module
    from vist3a_tpu_torch.nn import clip as clip_mod

    folder = Path(path)
    sd = load_sharded_safetensors(folder)
    hf = json.loads((folder / "config.json").read_text())
    vc, tc = hf["vision_config"], hf["text_config"]
    vcfg = clip_mod.CLIPVisionConfig(
        hidden_size=vc["hidden_size"], num_layers=vc["num_hidden_layers"],
        num_heads=vc["num_attention_heads"],
        mlp_dim=vc["intermediate_size"], patch_size=vc["patch_size"],
        image_size=vc["image_size"], projection_dim=hf["projection_dim"],
        act=vc.get("hidden_act", "quick_gelu"))
    tcfg = clip_mod.CLIPTextConfig(
        hidden_size=tc["hidden_size"], num_layers=tc["num_hidden_layers"],
        num_heads=tc["num_attention_heads"],
        mlp_dim=tc["intermediate_size"], vocab_size=tc["vocab_size"],
        context_length=tc["max_position_embeddings"],
        projection_dim=hf["projection_dim"],
        act=tc.get("hidden_act", "quick_gelu"))
    dtype = sd["visual_projection.weight"].dtype
    vision = build_module(
        lambda: clip_mod.CLIPVision(vcfg),
        clip_mod.import_hf_clip_vision(sd, vcfg.num_layers),
        device=device, dtype=dtype)
    text = build_module(
        lambda: clip_mod.CLIPText(tcfg),
        clip_mod.import_hf_clip_text(sd, tcfg.num_layers),
        device=device, dtype=dtype)
    tok = CLIPTokenizer.from_files(str(folder / "vocab.json"),
                                   str(folder / "merges.txt"))
    text_fn = scorers.make_clip_text_features(text, tok)
    return scorers.make_clip_scorer(vision, text_fn), vision


def build_scorers(args, *, tokenizer=None,
                  device: torch.device | str = "cuda") -> dict:
    """The scorers the flags name, each on `device`; `tokenizer` is the
    judge's."""
    import numpy as np

    from vist3a_tpu_torch.eval import musiq, scorers

    out = {}
    if getattr(args, "model_path", None):
        _, unified = _load_judge_callables(args.model_path,
                                           tokenizer=tokenizer, device=device)
        out["unified_reward"] = unified
    clip_vision = None
    if getattr(args, "clip_path", None):
        out["clip"], clip_vision = _load_clip_scorer(args.clip_path,
                                                     device=device)
    if getattr(args, "longclip_path", None):
        out["longclip"], _ = _load_clip_scorer(args.longclip_path,
                                               device=device)
    if getattr(args, "aesthetic_probe", None) and clip_vision is not None:
        probe = np.load(args.aesthetic_probe, allow_pickle=True).item() \
            if args.aesthetic_probe.endswith(".npy") else None
        if probe is not None:
            out["aesthetic"] = scorers.make_aesthetic_scorer(
                clip_vision, probe["weight"], probe["bias"])
    if getattr(args, "musiq_weights", None):
        out["musiq"] = musiq.make_musiq_scorer(
            musiq.load_musiq_npz(args.musiq_weights, device=device))
    return out


def main_t3(args, *, tokenizer=None,
            device: torch.device | str = "cuda") -> dict:
    from vist3a_tpu_torch.eval.gen_eval import run_scene_eval
    from vist3a_tpu_torch.eval.metrics import full_fp32

    with full_fp32():
        result = run_scene_eval(args.folder_path,
                                build_scorers(args, tokenizer=tokenizer,
                                              device=device),
                                num_frames=args.num_frames,
                                res_path=args.eval_save_path)
    print(json.dumps(result["summary"], indent=2))
    return result


def main_dpg(args, *, tokenizer=None,
             device: torch.device | str = "cuda") -> dict:
    from vist3a_tpu_torch.eval.gen_eval import (prepare_dpg_questions,
                                                run_dpg_eval)
    from vist3a_tpu_torch.eval.metrics import full_fp32

    with open(args.csv) as f:
        rows = list(csv_mod.DictReader(f))
    questions = prepare_dpg_questions(rows)
    with full_fp32():
        vqa, _ = _load_judge_callables(args.model_path, tokenizer=tokenizer,
                                       device=device)
        result = run_dpg_eval(args.folder_path, questions, vqa,
                              num_frames=args.num_frames,
                              res_path=args.res_path)
    print(json.dumps({"dpg_score": result["dpg_score"], "l1": result["l1"]},
                     indent=2))
    return result


def main(argv=None, tokenizer=None, *,
         device: torch.device | str = "cuda") -> dict:
    """`gen_eval {t3,dpg} [--flags]`; returns the main's result.
    `tokenizer` is the judge's (else `transformers.AutoTokenizer` of
    `--model-path`)."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("t3", "dpg"):
        raise SystemExit("usage: gen_eval {t3,dpg} [--flags]  "
                         "(t3 = SceneBench/T3-Bench, dpg = DPG-Bench)")
    if argv[0] == "t3":
        return main_t3(t3_argument().parse_args(argv[1:]),
                       tokenizer=tokenizer, device=device)
    return main_dpg(dpg_argument().parse_args(argv[1:]),
                    tokenizer=tokenizer, device=device)


if __name__ == "__main__":
    main()
