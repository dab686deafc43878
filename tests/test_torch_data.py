"""The port's data pipeline and metric stream against the JAX package's
(`vist3a_tpu/data/{preprocessing,datasets,loader}.py`,
`vist3a_tpu/core/wandb_log.py`).

On synthetic scene trees in the reference layouts (DL3DV `*/*/images_4/
frame_XXXXX.png` with a caption JSON, ScanNet `*/frames/color/<i>.png`) and
a prompt list, both packages get the same files, indices and seeds.  Every
comparison is exact (`assert_array_equal`): the host numpy arithmetic and
the draws (the window picks, the colour jitter, the sampler permutation,
each sample's `PCG64((seed, epoch, index))`) are the JAX package's.
"""

import argparse
import json
import sys
import types

import numpy as np
import pytest

from vist3a_tpu.core import wandb_log as jlog
from vist3a_tpu.data import datasets as jds
from vist3a_tpu.data import loader as jloader
from vist3a_tpu.data import preprocessing as jpp
from vist3a_tpu_torch.core import wandb_log as tlog
from vist3a_tpu_torch.data import datasets as tds
from vist3a_tpu_torch.data import loader as tloader
from vist3a_tpu_torch.data import preprocessing as tpp

FRAMES = 24
ARGS = dict(num_images_from_unit_scene=5, num_frames_per_unit_scene=9,
            resolution=32, feedforward_resolution=28)


def _frame(rng, i: int, hw=(40, 60)) -> np.ndarray:
    """A structured frame: a moving blob over a gradient, plus noise."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy = 10 + 2 * i, 12 + i % 7
    blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 40.0)
    img = np.stack([blob, xx / w, yy / h], axis=-1) * 200
    img += rng.integers(0, 40, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for batch, scene in (("1K", "scene_a"), ("1K", "scene_b"),
                         ("2K", "scene_c")):
        d = root / "dl3dv" / batch / scene / "images_4"
        d.mkdir(parents=True)
        for i in range(FRAMES):
            Image.fromarray(_frame(rng, i)).save(d / f"frame_{i:05d}.png")
    for scene in ("scene0000_00", "scene0001_00"):
        d = root / "scannet" / scene / "frames" / "color"
        d.mkdir(parents=True)
        for i in range(14):
            Image.fromarray(_frame(rng, i, (36, 48))).save(d / f"{i}.png")
    ann = [{"scene_name": "scene_a",
            "caption": {"cap_0_23": "a synthetic scene",
                        "cap_3_12": "the middle of it"}},
           {"scene_name": "scene_c", "caption": {"cap_2_20": "another"}}]
    (root / "captions.json").write_text(json.dumps(ann))
    (root / "prompts.txt").write_text("a red chair\n\na wooden boat\n")
    return root


def _equal_samples(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_load_image_pil_and_cv2_agree(trees, monkeypatch):
    path = trees / "dl3dv" / "1K" / "scene_a" / "images_4" / "frame_00003.png"
    pil = tpp.load_image(path)
    np.testing.assert_array_equal(pil, jpp.load_image(path))
    monkeypatch.setitem(sys.modules, "PIL", None)    # `import PIL` fails
    cv = tpp.load_image(path)
    assert cv.shape == (3, 40, 60) and cv.dtype == np.float32
    np.testing.assert_array_equal(cv, pil)
    with pytest.raises(OSError):
        tpp.load_image(trees / "captions.json")


@pytest.mark.parametrize("shape,size,antialias", [
    ((5, 3, 60, 90), (32, 48), False), ((5, 3, 60, 90), (28, 28), True),
    ((60, 90), (75, 120), True), ((2, 1, 3, 17, 9), (8, 8), False)])
def test_resize_matches_jax(shape, size, antialias):
    """The resizes are the JAX package's, bit for bit, down and up, at any
    leading shape (numpy's einsum sums in another order when the same
    planes come one at a time, so the batched calls must stay)."""
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    got = tpp._resize(x, size, antialias)
    assert got.shape == shape[:-2] + size and got.dtype == np.float32
    np.testing.assert_array_equal(got, jpp._resize(x, size, antialias))


@pytest.mark.parametrize("aug", [False, True])
def test_stitching_datasets_match_jax(trees, aug):
    """DL3DV and ScanNet clips, every index, jitter on and off."""
    for name, kw in (("dl3dv", {}), ("scannet", {})):
        cls = {"dl3dv": (tds.DL3DVStitchingDataset,
                         jds.DL3DVStitchingDataset),
               "scannet": (tds.ScannetUnlabeledDataset,
                           jds.ScannetUnlabeledDataset)}[name]
        mine, theirs = (c(str(trees / name), 5, 9, image_resolution=32,
                          feedforward_image_resolution=28,
                          color_augmentation=aug, **kw) for c in cls)
        assert mine.sequences == theirs.sequences and len(mine) > 1
        for idx in range(len(mine)):
            a = mine.get(idx, np.random.default_rng(idx + 7))
            b = theirs.get(idx, np.random.default_rng(idx + 7))
            _equal_samples(a, b)
            assert a["vae_image_tensor"].shape == (3, 5, 32, 32)


def test_text_paired_and_prompt_datasets_match_jax(trees):
    kw = dict(image_resolution=32,
              text_annotation_path=str(trees / "captions.json"))
    mine = tds.DL3DVTextPairedDataset(str(trees / "dl3dv"), 4, 32, **kw)
    theirs = jds.DL3DVTextPairedDataset(str(trees / "dl3dv"), 4, 32, **kw)
    assert mine.sequences == theirs.sequences and len(mine) == 2
    for idx in range(2):
        for seed in range(3):
            _equal_samples(mine.get(idx, np.random.default_rng(seed)),
                           theirs.get(idx, np.random.default_rng(seed)))
    p = str(trees / "prompts.txt")
    assert tds.TextPromptDataset(p).prompts == \
        jds.TextPromptDataset(p).prompts == ["a red chair", "a wooden boat"]


@pytest.mark.parametrize("shuffle", [False, True])
def test_sampler_over_two_replicas_matches_jax(shuffle):
    for n in (7, 8):
        for epoch in (0, 3):
            for rank in (0, 1):
                mine = tloader.ShardedSampler(n, 2, rank, shuffle=shuffle)
                theirs = jloader.ShardedSampler(n, 2, rank, shuffle=shuffle)
                mine.set_epoch(epoch)
                theirs.set_epoch(epoch)
                np.testing.assert_array_equal(mine.indices(),
                                              theirs.indices())
                assert len(mine) == len(theirs)


def _batches(loader) -> list:
    return list(loader)


def test_stitching_loader_matches_jax(trees):
    """Both datasets concatenated, jitter on, two replicas, two epochs, and
    `skip_first_batches`."""
    args = argparse.Namespace(batch_size=1, **ARGS)
    pairs = [("dl3dv", str(trees / "dl3dv")),
             ("scannet", str(trees / "scannet"))]
    for rank in (0, 1):
        mine, msmp = tloader.create_stitching_dataloader(
            pairs, args, augmentation=True, num_replicas=2, rank=rank)
        theirs, jsmp = jloader.create_stitching_dataloader(
            pairs, args, augmentation=True, num_replicas=2, rank=rank)
        assert len(mine) == len(theirs) == 3
        for epoch in (0, 1):
            msmp.set_epoch(epoch)
            jsmp.set_epoch(epoch)
            a, b = _batches(mine), _batches(theirs)
            assert len(a) == len(b) == 3
            for x, y in zip(a, b):
                _equal_samples(x, y)
        mine.skip_first_batches(2)
        theirs.skip_first_batches(2)
        a, b = _batches(mine), _batches(theirs)
        assert len(a) == len(b) == 1
        _equal_samples(a[0], b[0])


def test_vdm_loader_pair_matches_jax(trees):
    args = argparse.Namespace(batch_size=1, num_images_from_unit_scene=4,
                              num_frames_per_unit_scene=32, resolution=32,
                              text_annotation_path=str(trees /
                                                       "captions.json"))
    pairs = [("dl3dv", str(trees / "dl3dv")),
             ("text", str(trees / "prompts.txt"))]
    mine = tloader.create_vdm_tuning_dataloader(pairs, args)
    theirs = jloader.create_vdm_tuning_dataloader(pairs, args)
    assert mine[1] is mine[3] is None
    for m, t in ((mine[0], theirs[0]), (mine[2], theirs[2])):
        assert len(m) == len(t)
        m.sampler.set_epoch(2)
        t.sampler.set_epoch(2)
        for x, y in zip(_batches(m), _batches(t), strict=True):
            _equal_samples(x, y)
    assert [b["prompt"] for b in mine[0]] == [["a red chair"],
                                              ["a wooden boat"]]


def test_loader_raises_a_worker_error():
    """A sample that raises ends the pass with its error (the JAX loader
    would wait for the missing batch forever)."""
    class Broken:
        def get(self, idx, rng):
            if idx == 1:
                raise RuntimeError("bad sample")
            return {"x": np.asarray([idx])}

    loader = tloader.BatchLoader(Broken(), 1,
                                 tloader.ShardedSampler(3, shuffle=False),
                                 num_workers=2)
    with pytest.raises(RuntimeError, match="bad sample"):
        list(loader)


def test_run_logger_matches_jax(tmp_path, monkeypatch):
    """No-op when off; the JSONL fallback without `wandb` writes the JAX
    package's records; with a (fake) `wandb` the run gets the same calls;
    a `wandb.init` that fails falls back to JSONL."""
    for mod, sub in ((tlog, "torch"), (jlog, "jax")):
        off = mod.make_run(False, out_dir=tmp_path / sub)
        off.log({"loss": 1.0}, step=0)
        off.finish()
        lg = mod.make_run(True, run_name="exp", out_dir=tmp_path / sub)
        lg.log({"loss": 0.5, "grad_norm": np.float32(2.0), "skipped": False,
                "prompt": "p", "idx": [1, 2]}, step=1)
        lg.log_images("images", [np.zeros((4, 4, 3))], step=1)
        lg.finish()
    assert (tmp_path / "torch" / "exp.metrics.jsonl").read_text() == \
        (tmp_path / "jax" / "exp.metrics.jsonl").read_text()
    assert tlog.process_index() == 0

    def fake_run(record: list):
        run = types.SimpleNamespace()
        run.log = lambda d, step=None: record.append(
            (d if "images" not in d else {"images": len(d["images"])}, step))
        run.finish = lambda: record.append("finish")
        return run

    calls = {}
    for mod in (tlog, jlog):
        record = calls.setdefault(mod.__name__, [])
        fake = types.ModuleType("wandb")
        fake.init = lambda project, name, config, r=record: fake_run(r)
        fake.Image = lambda arr, caption=None: (arr.min(), arr.max())
        monkeypatch.setitem(sys.modules, "wandb", fake)
        lg = mod.make_run(True, project="p", run_name="n", config={})
        lg.log({"total_loss": 1.0}, step=7)
        lg.log_images("images", [np.full((2, 2, 3), 2.0)], step=7)
        lg.finish()
    assert calls[tlog.__name__] == calls[jlog.__name__] == [
        ({"total_loss": 1.0}, 7), ({"images": 1}, 7), "finish"]

    def fail(**kw):
        raise ConnectionError("offline")
    fake = types.ModuleType("wandb")
    fake.init = lambda project, name, config: fail()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    with pytest.warns(UserWarning, match="wandb.init failed"):
        lg = tlog.make_run(True, run_name="x", out_dir=tmp_path)
    lg.log({"a": 1}, step=0)
    lg.finish()
    assert json.loads((tmp_path / "x.metrics.jsonl").read_text()) == \
        {"a": 1.0, "step": 0}


def test_port_imports_without_the_optional_packages():
    """Every module of the port imports in a process where `jax`, the JAX
    package, `regex`, `transformers`, `imageio`, `wandb`, `safetensors`
    and Pillow cannot be imported (the card machine lacks most of them);
    no module names `regex` anywhere."""
    import ast
    import subprocess
    from pathlib import Path

    port = Path(__file__).resolve().parent.parent / "vist3a_tpu_torch"
    modules = sorted(
        ".".join(p.relative_to(port.parent).with_suffix("").parts)
        for p in port.rglob("*.py") if p.name != "__init__.py")
    blocked = ("jax", "vist3a_tpu", "regex", "transformers", "imageio",
               "wandb", "safetensors", "PIL")
    for p in port.rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "regex" for n in names), p
    code = ("import sys\n"
            f"for m in {blocked!r}:\n    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n    importlib.import_module(m)\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=port.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert {"vist3a_tpu_torch.data.clip_tokenizer",
            "vist3a_tpu_torch.search.ridge", "vist3a_tpu_torch.cli.find_layer",
            "vist3a_tpu_torch.core.wandb_log"} <= set(modules)
