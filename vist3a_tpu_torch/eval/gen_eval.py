"""Generation-evaluation harness: SceneBench / T3-Bench and DPG-Bench.

Port of `vist3a_tpu/eval/gen_eval.py` (the reference's
`evaluation/gen_eval/`), host code as there (numpy, `re`, OpenCV):

  * `t3_scene_evaluation.py:90-160`: per-prompt folders {gs.mp4,
    prompt.txt} → `num_frames` evenly sampled frames → the UnifiedReward
    judge's alignment / coherence / style, CLIPScore, LongCLIP, the
    aesthetic probe and MUSIQ → a JSON of per-prompt rows and their means;
  * `gen_metrics/unified_reward.py:29-53`: the parser of the judge's
    "Alignment/Coherence/Style Score (1-5): X" lines, and the judging
    prompt (:67-133), verbatim;
  * `dpg_evaluation.py:159-264`: the per-prompt question graph, yes/no VQA
    per question and frame, a child zeroed when a parent is answered no,
    the per-category L1 / L2 means ×100.

The scorers plug in as callables (`cli/gen_eval.py::build_scorers` builds
them from the port's models):

    scorers = {"unified_reward": fn(images, prompt) -> str (judge output),
               "clip":           fn(images, prompt) -> float,
               "longclip":       fn(images, prompt) -> float,
               "aesthetic":      fn(images) -> float,
               "musiq":          fn(images) -> float}
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

_FLOAT = r"[-+]?\d*\.?\d+"

UNIFIED_REWARD_PROMPT = (
    "You are presented with a generated image and its associated text "
    "caption. Your task is to analyze the image across multiple dimensions "
    "in relation to the caption. Specifically:\n\n"
    "1. Evaluate each word in the caption based on how well it is visually "
    "represented in the image. Assign a numerical score to each word using "
    "the format:\n"
    '   Word-wise Scores: [["word1", score1], ["word2", score2], ..., '
    '["wordN", scoreN], ["[No_mistakes]", scoreM]]\n'
    "   - A higher score indicates that the word is less well represented "
    "in the image.\n"
    "   - The special token [No_mistakes] represents whether all elements "
    "in the caption were correctly depicted. A high score suggests no "
    "mistakes; a low score suggests missing or incorrect elements.\n\n"
    "2. Provide overall assessments for the image along the following axes "
    "(each rated from 1 to 5):\n"
    "- Alignment Score: How well the image matches the caption in terms of "
    "content.\n"
    "- Coherence Score: How logically consistent the image is (absence of "
    "visual glitches, object distortions, etc.).\n"
    "- Style Score: How aesthetically appealing the image looks, regardless "
    "of caption accuracy.\n\n"
    "Output your evaluation using the format below:\n\n---\n\n"
    'Word-wise Scores: [["word1", score1], ..., ["[No_mistakes]", scoreM]]'
    "\n\n"
    "Alignment Score (1-5): X\n"
    "Coherence Score (1-5): Y\n"
    "Style Score (1-5): Z\n\n"
    "Your task is provided as follows:\nText Caption: [{prompt}]\n"
    "ASSISTANT:\n"
)


def _find_first_float(text: str) -> Optional[float]:
    m = re.search(_FLOAT, text)
    return float(m.group()) if m else None


def parse_unified_scores(text: str) -> Dict[str, float]:
    """`gen_metrics/unified_reward.py:29-53`, verbatim grammar."""
    def grab(label: str) -> Optional[float]:
        pattern = rf"{label}\s*Score?(?:\s*\(.*?\))?\s*[:\-]\s*({_FLOAT})"
        m = re.search(pattern, text, flags=re.IGNORECASE)
        if m:
            return float(m.group(1))
        for line in text.splitlines():
            if label.lower() in line.lower():
                val = _find_first_float(line)
                if val is not None:
                    return val
        return None

    out = {"alignment": grab("Alignment"), "coherence": grab("Coherence"),
           "style": grab("Style")}
    missing = [k for k, v in out.items() if v is None]
    if missing:
        raise ValueError(f"Could not parse: {', '.join(missing)}")
    return out


def sample_video_frames(video_path, num_frames: int = 8) -> list:
    """Evenly sample frames from gs.mp4 → list of (H,W,3) uint8 RGB."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    idx = np.linspace(0, max(total - 1, 0), num_frames).astype(int)
    frames = []
    for i in idx:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        if ok:
            frames.append(frame[..., ::-1].copy())
    cap.release()
    return frames


def discover_prompt_folders(root) -> list:
    """{folder: (gs.mp4, prompt.txt)} pairs
    (`t3_scene_evaluation.py:90-110`)."""
    out = []
    for d in sorted(Path(root).iterdir()):
        if (d / "gs.mp4").exists() and (d / "prompt.txt").exists():
            out.append((d, (d / "prompt.txt").read_text().strip()))
    return out


def run_scene_eval(root, scorers: Dict[str, Callable], *,
                   num_frames: int = 8, res_path=None) -> dict:
    """SceneBench / T3-Bench loop (`t3_scene_evaluation.py:90-160`)."""
    results = []
    for folder, prompt in discover_prompt_folders(root):
        frames = sample_video_frames(folder / "gs.mp4", num_frames)
        row = {"prompt": prompt, "folder": str(folder)}
        if "unified_reward" in scorers:
            parsed = [parse_unified_scores(scorers["unified_reward"]([f],
                                                                     prompt))
                      for f in frames]
            for k in ("alignment", "coherence", "style"):
                row[k] = float(np.mean([p[k] for p in parsed]))
        for name in ("clip", "longclip"):
            if name in scorers:
                row[name] = float(scorers[name](frames, prompt))
        for name in ("aesthetic", "musiq"):
            if name in scorers:
                row[name] = float(scorers[name](frames))
        results.append(row)

    keys = [k for k in results[0] if k not in ("prompt", "folder")] \
        if results else []
    summary = {k: float(np.mean([r[k] for r in results])) for k in keys}
    out = {"per_prompt": results, "summary": summary}
    if res_path:
        Path(res_path).write_text(json.dumps(out, indent=2))
    return out


# --------------------------------------------------------------------------- #
# DPG-Bench                                                                   #
# --------------------------------------------------------------------------- #
def prepare_dpg_questions(csv_rows) -> dict:
    """CSV rows (item_id, text, question, keyword [tuple], dependency,
    proposition_id) → {prompt: {qid2tuple, qid2question, qid2dependency}}
    (`dpg_evaluation.py:126-155` semantics)."""
    out: dict = {}
    for row in csv_rows:
        prompt = row["text"]
        entry = out.setdefault(prompt, {"qid2tuple": {}, "qid2question": {},
                                        "qid2dependency": {}})
        qid = int(row["proposition_id"])
        entry["qid2tuple"][qid] = row["keyword"]
        entry["qid2question"][qid] = row["question"]
        entry["qid2dependency"][qid] = [
            int(d) for d in str(row["dependency"]).split(",")]
    return out


def compute_dpg_one_sample(question_entry: dict, images, vqa: Callable):
    """`dpg_evaluation.py:159-195`: yes/no VQA per question per image,
    dependency zeroing, mean over questions then images."""
    qid2question = question_entry["qid2question"]
    qid2dependency = question_entry["qid2dependency"]
    scores = []
    qid2scores_orig = {}
    for img in images:
        qid2scores = {}
        for qid, question in qid2question.items():
            qid2scores[qid] = float(vqa(img, question) == "Yes")
        qid2scores_orig = qid2scores.copy()
        for qid, parents in qid2dependency.items():
            for parent in parents:
                if parent == 0:
                    continue
                if qid2scores.get(parent, 1) == 0:
                    qid2scores[qid] = 0
                    break
        scores.append(sum(qid2scores.values()) / len(qid2scores))
    return sum(scores) / len(scores), qid2scores_orig


def aggregate_dpg(per_prompt_scores: list, category_scores: dict) -> dict:
    """L1/L2 category aggregation ×100 (`dpg_evaluation.py:242-264`)."""
    l1 = defaultdict(list)
    for category, vals in category_scores.items():
        l1[category.split("-")[0].strip()].extend(vals)
    return {
        "dpg_score": float(np.mean(per_prompt_scores) * 100),
        "l1": {k: float(np.mean(v) * 100) for k, v in l1.items()},
        "l2": {k: float(np.mean(v) * 100)
               for k, v in sorted(category_scores.items())},
    }


def run_dpg_eval(root, question_dict: dict, vqa: Callable, *,
                 num_frames: int = 8, res_path=None) -> dict:
    scores, cat2scores = [], defaultdict(list)
    for folder, prompt in discover_prompt_folders(root):
        entry = question_dict.get(prompt)
        if entry is None:
            continue
        frames = sample_video_frames(folder / "gs.mp4", num_frames)
        score, qid2scores = compute_dpg_one_sample(entry, frames, vqa)
        scores.append(score)
        for qid, tup in entry["qid2tuple"].items():
            category = str(tup).split("(")[0].strip()
            cat2scores[category].append(qid2scores[qid])
    out = aggregate_dpg(scores, dict(cat2scores))
    if res_path:
        Path(res_path).write_text(json.dumps(out, indent=2))
    return out
