"""RE10K novel-view-synthesis evaluation dataset (host-side numpy).

Port of `vist3a_tpu/eval/re10k.py` (the reference's
`evaluation/datasets/re10k_nvs.py`): per-sequence `annotations.json` with
{idx, filepath, intrinsics, extrinsics}; `rescale_image_w_crop` — a
Lanczos resize of the shorter side to the VAE size, a centre crop to a
square, a second Lanczos resize to the feed-forward size, the intrinsics
rescaled with the pixel-centre (+0.5) convention at each stage; `get_data`
returns the feed-forward images, the VAE images, intrinsics and
extrinsics of the requested frame ids.

The JAX package resizes with Pillow's `Image.LANCZOS`.  Pillow is optional
in the port (OpenCV's `INTER_LANCZOS4` computes something else), so
`pil_resize` is Pillow's 8-bit two-pass resample written in numpy
(`ImagingResample`, `libImaging/Resample.c`): per output pixel the
filter's taps over a support of (the filter's support)·max(scale, 1)
input pixels, normalised in double, rounded to 22-bit fixed point away
from zero, accumulated in integers from 1 << 21, shifted and clipped to
uint8 after the horizontal and again after the vertical pass.  A pass
whose size does not change is skipped, as Pillow skips it.  The filters
are Lanczos-3 (`lanczos_resize`, the RE10K frames) and Keys' bicubic with
a = −0.5 and support 2 (`bicubic_resize`, the Qwen judge's
`eval/qwen_judge.py::preprocess_image`).  The result equals Pillow's byte
for byte.

Images decode with PIL where it imports and with `cv2.imread` otherwise
(`data/preprocessing.py::load_rgb`): a PNG decodes to the same bytes
either way.
"""

from __future__ import annotations

import functools
import json
import math
import os
import os.path as osp
from typing import Iterable, Optional

import numpy as np

from vist3a_tpu_torch.data.preprocessing import load_rgb

PRECISION_BITS = 32 - 8 - 2          # Pillow's fixed-point coefficients


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """Pillow's `lanczos_filter`: sinc(x)·sinc(x/3) on [−3, 3)."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


def _bicubic(x: float) -> float:
    """Pillow's `bicubic_filter`: Keys' cubic with a = −0.5 on (−2, 2)."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# Pillow's filters by name: (the function, its support)
FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=32)
def _coefficients(n_in: int, n_out: int, filt: str) -> np.ndarray:
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` as a dense
    (n_in, n_out) matrix of its 22-bit fixed-point weights (integers held
    in float64)."""
    fn, filter_support = FILTERS[filt]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ss = 1.0 / filterscale
    kk = np.zeros((n_in, n_out), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)      # C casts truncate
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:                                     # C's summation order
            total += v
        for x, v in enumerate(w):
            kk[xmin + x, xx] = v / total if total != 0.0 else v
    fixed = kk * (1 << PRECISION_BITS)
    return np.where(kk < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed))


def _pass(image: np.ndarray, n_out: int, axis: int, filt: str) -> np.ndarray:
    """One of Pillow's passes along `axis` of an (H, W, C) uint8 image.
    Every product and partial sum is an integer below 2³¹ (Pillow sums in
    int32), so the float64 matrix product is exact in any order; a sum
    below zero or above 255 is clipped, as Pillow's `clip8` does."""
    k = _coefficients(image.shape[axis], n_out, filt)
    src = np.moveaxis(image, axis, -1).astype(np.float64)   # (..., n_in)
    acc = (src @ k).astype(np.int64) + (1 << (PRECISION_BITS - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


def pil_resize(image: np.ndarray, size_wh: tuple[int, int],
               filt: str) -> np.ndarray:
    """(H, W, C) uint8 → (h, w, C) uint8, `PIL.Image.resize((w, h),
    filter)` bit for bit for the 8-bit `filt` ∈ FILTERS: the horizontal
    pass, then the vertical; a pass whose size does not change is
    skipped."""
    w, h = size_wh
    out = np.ascontiguousarray(image)
    if w != out.shape[1]:
        out = _pass(out, w, 1, filt)
    if h != out.shape[0]:
        out = _pass(out, h, 0, filt)
    return out


def lanczos_resize(image: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.resize((w, h), Image.LANCZOS)` bit for bit."""
    return pil_resize(image, size_wh, "lanczos")


def bicubic_resize(image: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.resize((w, h), Image.BICUBIC)` bit for bit."""
    return pil_resize(image, size_wh, "bicubic")


def _rescale_k(intrinsic: np.ndarray, scale: float,
               pixel_center: bool) -> np.ndarray:
    if pixel_center:
        intrinsic[0, 2] += 0.5
        intrinsic[1, 2] += 0.5
    intrinsic[:2, :] *= scale
    if pixel_center:
        intrinsic[0, 2] -= 0.5
        intrinsic[1, 2] -= 0.5
    return intrinsic


def rescale_image_w_crop(image: np.ndarray, intrinsic: np.ndarray,
                         output_width_1: int, output_width_2: int,
                         pixel_center: bool = True):
    """(H, W, 3) uint8 + 3×3 intrinsic → (feed-forward image, intrinsic,
    VAE image), both uint8, as the JAX package's PIL version computes them
    (`re10k_nvs.py:25-86`; the reference reads (H, W) from PIL's
    `image.size`, which is (W, H) — the scale takes the min, so the square
    output is unaffected, and the quirk is kept)."""
    size = (image.shape[1], image.shape[0])                 # PIL's (W, H)
    h, w = map(float, size)
    scale = output_width_1 / min(h, w)
    new_h = round(size[1] * scale)
    new_w = round(size[0] * scale)
    image_first = lanczos_resize(image, (new_w, new_h))

    intrinsic = _rescale_k(np.array(intrinsic, np.float64), scale,
                           pixel_center)
    x0 = max((new_w - output_width_1) // 2, 0)
    y0 = max((new_h - output_width_1) // 2, 0)
    image_first = image_first[y0:y0 + output_width_1,
                              x0:x0 + output_width_1]
    intrinsic = intrinsic.copy()
    intrinsic[0, 2] -= x0
    intrinsic[1, 2] -= y0

    size1 = (image_first.shape[1], image_first.shape[0])
    h2, w2 = map(float, size1)
    scale2 = output_width_2 / min(h2, w2)
    image_second = lanczos_resize(
        image_first, (round(size1[0] * scale2), round(size1[1] * scale2)))
    intrinsic = _rescale_k(intrinsic, scale2, pixel_center)
    return image_second, intrinsic, image_first


class Re10KNVSDataset:
    def __init__(self, re10k_dir, split: str = "test",
                 load_img_size: int = 512, feedforward_img_size: int = 448,
                 sort_by_filename: bool = False,
                 cache_file: str | None = None, seq_file: str | None = None):
        if split != "test":
            raise ValueError("We don't want to train on Re10K")
        self.re10k_dir = re10k_dir
        self.load_img_size = load_img_size
        self.feedforward_img_size = feedforward_img_size
        self.sort_by_filename = sort_by_filename

        if cache_file and osp.exists(cache_file):
            self.metadata = np.load(cache_file, allow_pickle=True).item()
            self.sequence_list = sorted(self.metadata.keys())
            return

        if seq_file is not None:
            with open(seq_file) as f:
                self.sequence_list = [x.strip() for x in f if x.strip()]
        else:
            self.sequence_list = sorted(os.listdir(re10k_dir))

        self.metadata = {}
        for seq in self.sequence_list:
            anno_path = osp.join(re10k_dir, seq, "annotations.json")
            try:
                with open(anno_path) as f:
                    annos = json.load(f)
            except Exception:
                continue
            self.metadata[seq] = [
                {"idx": a["idx"], "filepath": a["filepath"],
                 "intrinsics": np.asarray(a["intrinsics"], np.float64),
                 "extrinsics": np.asarray(a["extrinsics"], np.float64)}
                for a in annos]
        self.sequence_list = sorted(self.metadata.keys())
        if cache_file:
            np.save(cache_file, self.metadata)   # idempotent cache

    def __len__(self):
        return len(self.sequence_list)

    def get_seq_framenum(self, sequence_name: str) -> int:
        return len(self.metadata[sequence_name])

    def get_data(self, sequence_name: Optional[str] = None,
                 index: Optional[int] = None,
                 ids: Optional[Iterable] = None) -> dict:
        if sequence_name is None:
            sequence_name = self.sequence_list[index]
        metadata = self.metadata[sequence_name]
        if ids is None:
            ids = np.arange(len(metadata))
        annos = [metadata[i] for i in ids]
        if self.sort_by_filename:
            annos = sorted(annos, key=lambda x: x["filepath"])

        images, vae_images = [], []
        extr = np.broadcast_to(np.eye(4), (len(annos), 4, 4)).copy()
        intr = np.broadcast_to(np.eye(3), (len(annos), 3, 3)).copy()
        paths = []
        for i, anno in enumerate(annos):
            impath = osp.join(self.re10k_dir, anno["filepath"])
            ff, k, vae = rescale_image_w_crop(
                load_rgb(impath), anno["intrinsics"], self.load_img_size,
                self.feedforward_img_size)
            images.append(np.asarray(ff, np.float32).transpose(2, 0, 1)
                          / 255.0)
            vae_images.append(np.asarray(vae, np.float32).transpose(2, 0, 1)
                              / 255.0)
            ex = np.asarray(anno["extrinsics"], np.float64)
            if ex.shape != (4, 4):       # 3×4 annotations → homogeneous
                ex = np.vstack([ex, [0, 0, 0, 1]])
            extr[i] = ex
            intr[i] = k
            paths.append(impath)
        return {
            "seq_id": sequence_name, "n": len(metadata),
            "ind": np.asarray(list(ids)), "image_paths": paths,
            "extrs": extr.astype(np.float32),
            "intrs": intr.astype(np.float32),
            "images": np.stack(images),
            "vae_images": np.stack(vae_images),
        }
