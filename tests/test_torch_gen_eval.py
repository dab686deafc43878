"""The port's generation-evaluation harness (`vist3a_tpu_torch/eval/
gen_eval.py`) against the JAX package's `vist3a_tpu/eval/gen_eval.py`.

  * the judging prompt verbatim; `parse_unified_scores` on the reference
    grammar, the line fallback and unparseable text (both raise);
  * the DPG question graph, the dependency zeroing and the L1 / L2
    aggregation on seeded question graphs and answers: equal;
  * `sample_video_frames`, `discover_prompt_folders`, `run_scene_eval` and
    `run_dpg_eval` over real mp4 folders with deterministic stub scorers:
    the same frames, rows, summaries and files.
"""

import json

import numpy as np
import pytest

from vist3a_tpu.eval import gen_eval as jg
from vist3a_tpu_torch.eval import gen_eval as tg
from vist3a_tpu_torch.io.video_export import to_uint8_frames, write_mp4

TEXTS = [
    'Word-wise Scores: [["a", 0.1], ["[No_mistakes]", 0.9]]\n\n'
    "Alignment Score (1-5): 3.62\nCoherence Score (1-5): 4\n"
    "Style Score (1-5): 2.8\n",
    "alignment: 3\nthe Coherence was 4.5 overall\nStyle - 2",
    "ALIGNMENT SCORES - -1.5\ncoherence score: .25\nstyle: +4",
    "Alignment Score (1-5): 3\nCoherence Score (1-5): 4\n",
    "no scores here",
]


def test_prompt_is_jax():
    assert tg.UNIFIED_REWARD_PROMPT == jg.UNIFIED_REWARD_PROMPT


@pytest.mark.parametrize("text", TEXTS)
def test_parse_unified_scores_equals_jax(text):
    try:
        want = jg.parse_unified_scores(text)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tg.parse_unified_scores(text)
        return
    assert tg.parse_unified_scores(text) == want


def _graph(rng, n_q: int):
    """A random question graph: each question depends on 0 (none) or on an
    earlier one."""
    cats = ["entity - whole", "attribute - color", "relation - spatial",
            "entity - part"]
    rows = []
    for q in range(1, n_q + 1):
        dep = "0" if q == 1 or rng.random() < 0.3 else \
            ",".join(str(d) for d in sorted(set(rng.integers(1, q, 2))))
        rows.append({"item_id": "0", "text": "a red chair",
                     "question": f"question {q}?",
                     "keyword": f"{cats[q % 4]} (thing {q})",
                     "dependency": dep, "proposition_id": str(q)})
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_dpg_scoring_equals_jax(seed):
    rng = np.random.default_rng(seed)
    rows = _graph(rng, 6)
    entry_t = tg.prepare_dpg_questions(rows)
    assert entry_t == jg.prepare_dpg_questions(rows)
    answers = {(i, q): ("Yes" if rng.random() < 0.6 else "No")
               for i in range(3) for q in range(1, 7)}

    def vqa(img, question):
        return answers[(img, int(question.split()[1][:-1]))]

    entry = entry_t["a red chair"]
    assert tg.compute_dpg_one_sample(entry, [0, 1, 2], vqa) == \
        jg.compute_dpg_one_sample(entry, [0, 1, 2], vqa)
    scores = list(rng.random(5))
    cats = {c: list(rng.integers(0, 2, 3)) for c in (
        "entity - whole", "entity - part", "attribute - color")}
    assert tg.aggregate_dpg(scores, cats) == jg.aggregate_dpg(scores, cats)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    for i, prompt in enumerate(["a red chair", "a blue car", "a cat"]):
        d = root / f"scene_{i}"
        d.mkdir()
        frames = np.random.default_rng(i).random((6 + i, 3, 32, 48)).astype(
            np.float32)
        write_mp4(to_uint8_frames(frames), d / "gs.mp4", fps=5)
        if i < 2:                            # the third lacks its prompt
            (d / "prompt.txt").write_text(prompt + "\n")
    (root / "loose.txt").write_text("not a folder")
    return root


def test_frames_and_folders_equal_jax(scenes):
    folders = tg.discover_prompt_folders(scenes)
    assert folders == jg.discover_prompt_folders(scenes)
    assert [p for _, p in folders] == ["a red chair", "a blue car"]
    for n in (1, 4, 8):
        got = tg.sample_video_frames(folders[0][0] / "gs.mp4", n)
        want = jg.sample_video_frames(folders[0][0] / "gs.mp4", n)
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _stub_scorers():
    def unified(images, prompt):
        m = float(np.mean(images[0]))
        return (f"Alignment Score (1-5): {m / 50:.3f}\nCoherence Score "
                f"(1-5): {len(prompt) % 5}\nStyle Score (1-5): 2.5")

    return {
        "unified_reward": unified,
        "clip": lambda f, p: float(np.mean([x.std() for x in f])) + len(p),
        "longclip": lambda f, p: float(np.mean(f[-1])),
        "aesthetic": lambda f: float(np.mean([x[0, 0, 0] for x in f])),
        "musiq": lambda f: float(len(f)),
    }


def test_run_scene_eval_equals_jax(scenes, tmp_path):
    got = tg.run_scene_eval(scenes, _stub_scorers(), num_frames=4,
                            res_path=tmp_path / "port.json")
    want = jg.run_scene_eval(scenes, _stub_scorers(), num_frames=4,
                             res_path=tmp_path / "jax.json")
    assert got == want
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert len(got["per_prompt"]) == 2
    # a subset of scorers: only theirs
    sub = tg.run_scene_eval(scenes, {"musiq": lambda f: 1.0}, num_frames=2)
    assert sub["summary"] == {"musiq": 1.0}


def test_run_dpg_eval_equals_jax(scenes, tmp_path):
    rows = _graph(np.random.default_rng(7), 4)
    rows += [{**r, "text": "a blue car"} for r in _graph(
        np.random.default_rng(8), 3)]
    questions = tg.prepare_dpg_questions(rows)

    def vqa(img, question):
        return "Yes" if (int(img.mean() * 10) + len(question)) % 3 else "No"

    got = tg.run_dpg_eval(scenes, questions, vqa, num_frames=3,
                          res_path=tmp_path / "port.json")
    want = jg.run_dpg_eval(scenes, questions, vqa, num_frames=3,
                           res_path=tmp_path / "jax.json")
    assert got == want
    assert json.loads((tmp_path / "port.json").read_text()) == want
