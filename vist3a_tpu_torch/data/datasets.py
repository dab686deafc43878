"""Datasets (host-side numpy): DL3DV stitching clips, DL3DV clips with
captions (VDM), ScanNet unlabeled clips, prompt lists.

Port of `vist3a_tpu/data/datasets.py` (the reference's
`data/dl3dv_datasets.py`, `data/scannet_unlabeled_dataset.py` and
`data/prompt_dataset.py`): windowed frame sampling with frame 0 always
included and an unbounded retry with a resampled scene (:172-186);
caption ranges `*_start_end` with the first and last frame always included
and a bounded retry ×10 (:286-307).  The same glob order, `images_4/`
layout, annotation JSON and draws from the caller's generator, so a sample
equals the JAX package's bit for bit.

Each dataset exposes `__len__` / `get(idx, rng)`; the loader derives each
sample's numpy Generator from (seed, epoch, index).
"""

from __future__ import annotations

import json
import os
import re
from glob import glob
from pathlib import Path

import numpy as np

from vist3a_tpu_torch.data import preprocessing as pp


def _sample_window_indices(rng: np.random.Generator, num_frames: int,
                           n_images: int, n_window: int):
    """`dl3dv_datasets.py:140-157`: window length ∈ [n_images, n_window],
    random start, n_images−1 random picks from (0, window) + frame 0,
    sorted."""
    frames_per_scene = int(rng.integers(n_images, n_window + 1))
    start = int(rng.integers(0, max(num_frames - frames_per_scene - 1, 1)))
    picks = rng.choice(np.arange(1, frames_per_scene), n_images - 1,
                       replace=False).tolist()
    picks.append(0)
    picks.sort()
    return start, frames_per_scene, picks


class DL3DVStitchingDataset:
    """`DL3DVStitchingDataset` (`dl3dv_datasets.py:41-186`)."""

    def __init__(self, root_path: str, num_images_from_unit_scene: int,
                 num_frames_per_unit_scene: int, image_resolution: int = 512,
                 feedforward_image_resolution: int = 448,
                 color_augmentation: bool = True):
        self.root_path = root_path
        self.n_images = num_images_from_unit_scene
        self.n_window = num_frames_per_unit_scene
        self.resolution = image_resolution
        self.ff_resolution = feedforward_image_resolution
        self.color_augmentation = color_augmentation
        self.sequences = sorted(glob(str(root_path) + "/*/*/"))

    def __len__(self):
        return len(self.sequences)

    def _frames(self, seq: Path):
        return sorted(f for f in os.listdir(seq / "images_4")
                      if re.match(r"^frame_\d+", f))

    def _load_clip(self, rng, seq: Path):
        names = self._frames(seq)
        start, window, picks = _sample_window_indices(
            rng, len(names), self.n_images, self.n_window)
        names = names[start:start + window]
        imgs = np.stack([pp.load_image(seq / "images_4" / names[i])
                         for i in picks])
        imgs = pp.resize_shorter_crop_square_batch(imgs, self.resolution)
        if self.color_augmentation:
            imgs = pp.color_jitter(rng, imgs)
        ff = pp.resize_square(imgs, self.ff_resolution)
        return {
            "vae_image_tensor": pp.to_pm1(imgs).transpose(1, 0, 2, 3),
            "feedforward_image_tensor": pp.to_pm1(ff).transpose(1, 0, 2, 3),
        }

    def get(self, idx: int, rng: np.random.Generator):
        try:
            return self._load_clip(rng, Path(self.sequences[idx]))
        except Exception:
            # corrupt-scene fallback: resample forever (`:172-186`)
            while True:
                j = int(rng.integers(0, len(self.sequences)))
                try:
                    return self._load_clip(rng, Path(self.sequences[j]))
                except Exception:
                    continue


class ScannetUnlabeledDataset:
    """`ScannetUnlabeledDataaset` (`scannet_unlabeled_dataset.py`)."""

    def __init__(self, root_path: str, num_images_from_unit_scene: int,
                 num_frames_per_unit_scene: int, image_resolution: int = 512,
                 feedforward_image_resolution: int = 448,
                 color_augmentation: bool = True,
                 train_name_list_path: str | None = None):
        self.n_images = num_images_from_unit_scene
        self.n_window = num_frames_per_unit_scene
        self.resolution = image_resolution
        self.ff_resolution = feedforward_image_resolution
        self.color_augmentation = color_augmentation
        seqs = glob(str(root_path) + "/*/")
        if train_name_list_path and os.path.exists(train_name_list_path):
            with open(train_name_list_path) as f:
                keep = set(json.load(f))
            seqs = [s for s in seqs if s.split("/")[-2] in keep]
        self.sequences = sorted(seqs)

    def __len__(self):
        return len(self.sequences)

    def get(self, idx: int, rng: np.random.Generator):
        folder = os.path.join(self.sequences[idx], "frames", "color")
        names = sorted(os.listdir(folder), key=lambda x: int(x.split(".")[0]))
        start, window, picks = _sample_window_indices(
            rng, len(names), self.n_images, self.n_window)
        imgs = np.stack([pp.load_image(os.path.join(folder, names[i + start]))
                         for i in picks])
        imgs = pp.resize_shorter_crop_square_batch(imgs, self.resolution)
        if self.color_augmentation:
            imgs = pp.color_jitter(rng, imgs)
        ff = pp.resize_square(imgs, self.ff_resolution)
        return {
            "vae_image_tensor": pp.to_pm1(imgs).transpose(1, 0, 2, 3),
            "feedforward_image_tensor": pp.to_pm1(ff).transpose(1, 0, 2, 3),
        }


class DL3DVTextPairedDataset:
    """`DL3DVTextPairedDataset` (`dl3dv_datasets.py:189-307`)."""

    def __init__(self, root_path: str, num_images_from_unit_scene: int,
                 num_frames_per_unit_scene: int = 32,
                 image_resolution: int = 512,
                 text_annotation_path: str = "data/dl3dv_text_label_980P.json"):
        self.n_images = num_images_from_unit_scene
        self.resolution = image_resolution
        with open(text_annotation_path) as f:
            entries = json.load(f)
        self.scene_dict = {v["scene_name"]: v for v in entries}
        seqs = sorted(glob(str(root_path) + "/*/*/"))
        self.sequences = [
            s for s in seqs
            if os.path.basename(os.path.normpath(s)) in self.scene_dict]

    def __len__(self):
        return len(self.sequences)

    def _load(self, rng, idx):
        seq = Path(self.sequences[idx])
        name = os.path.basename(os.path.normpath(seq))
        captions = self.scene_dict[name]["caption"]
        key = list(captions.keys())[int(rng.integers(0, len(captions)))]
        caption = captions[key]
        lo, hi = int(key.split("_")[-2]), int(key.split("_")[-1])

        paths = []
        for p in sorted((seq / "images_4").glob("*.png")):
            m = re.findall(r"frame_(\d+)\.[^.]+$", p.name)
            if m and lo <= int(m[0]) <= hi:
                paths.append(p)
        imgs = [pp.load_image(p) for p in paths]
        imgs = [pp.resize_square(i[None], self.resolution)[0] for i in imgs]

        if self.n_images >= len(imgs):       # repeat last (`:260-266`)
            picks = list(range(len(imgs)))
            while len(picks) < self.n_images:
                picks.append(len(imgs) - 1)
        else:                                # first+last always (`:267-272`)
            picks = rng.choice(np.arange(1, len(imgs) - 1),
                               self.n_images - 2, replace=False).tolist()
            picks += [0, len(imgs) - 1]
            picks.sort()
        clip = np.stack([imgs[i] for i in picks])
        return {"image_tensor": pp.to_pm1(clip).transpose(1, 0, 2, 3),
                "caption": caption}

    def get(self, idx: int, rng: np.random.Generator):
        try:
            return self._load(rng, idx)
        except Exception:
            for _ in range(10):              # bounded retry (`:286-307`)
                j = int(rng.integers(0, len(self.sequences)))
                try:
                    return self._load(rng, j)
                except Exception:
                    continue
            raise RuntimeError("Exceeded maximum retry attempts")


class TextPromptDataset:
    """One prompt per line (`data/prompt_dataset.py`)."""

    def __init__(self, path: str):
        with open(path) as f:
            self.prompts = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.prompts)

    def get(self, idx: int, rng=None):
        return {"prompt": self.prompts[idx], "metadata": {"index": idx}}


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def get(self, idx: int, rng):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d].get(idx - int(self._offsets[d]), rng)
