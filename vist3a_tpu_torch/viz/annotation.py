"""Text labels on images.

Port of `vist3a_tpu/viz/annotation.py` (the reference's
`src/visualization/annotation.py`): black text on white, stacked above the
image with a 4-pixel gap, left-aligned.  The JAX package renders with
Pillow's default font (Pillow 12.1.0: Aileron Regular at size 10,
antialiased by FreeType, the reference's bundled font being absent); the
port draws from a glyph atlas of that font, `label_font.npz`, written and
checked against Pillow by `tools/torch_label_atlas.py`, with no Pillow at
run time.  A label is laid out as Pillow's basic layout lays it out: pen
positions at the sum of whole-pixel advances (the font has no kerning), the
width from the ink's and the pen's extent, each glyph's coverage composited
over the earlier ones as FreeType's bitmaps are in Pillow
(c ← s + (c·(255 − s) + 128 + …) >> 8), the pixel 255 − c.  Labels of
`EXPECTED_CHARACTERS` and spaces are equal to Pillow's bit for bit; another
character raises, and so does a font file (the JAX package would render
with it).
"""

from __future__ import annotations

import functools
from pathlib import Path
from string import ascii_letters, digits, punctuation

import numpy as np

from vist3a_tpu_torch.viz.layout import vcat

EXPECTED_CHARACTERS = digits + punctuation + ascii_letters
ATLAS = Path(__file__).resolve().parent / "label_font.npz"


@functools.cache
def _atlas() -> dict:
    with np.load(ATLAS) as f:
        a = {k: f[k] for k in f.files}
    glyphs = {}
    for i, code in enumerate(a["chars"]):
        h, w = a["shape"][i]
        bmp = a["bitmaps"][a["start"][i]:a["start"][i + 1]].reshape(h, w)
        glyphs[chr(code)] = (bmp.astype(np.int64), *a["origin"][i],
                             int(a["advance"][i]))
    return {"glyphs": glyphs, "height": int(a["height"])}


def draw_label(text: str, font_path: str | None = None,
               font_size: int = 24) -> np.ndarray:
    """Render `text` black-on-white → float32 (3, height, width) in [0, 1]
    (`annotation.py:16-36`).  The height is that of the whole expected
    character set, so labels of different strings stack at equal heights.
    `font_size` is ignored, as by the default font in the JAX package."""
    if font_path is not None and Path(str(font_path)).is_file():
        raise NotImplementedError(
            f"{font_path}: the port draws labels in its atlas font only")
    atlas = _atlas()
    glyphs = atlas["glyphs"]
    missing = sorted(set(text) - set(glyphs))
    if missing:
        raise ValueError(f"no glyph for {missing} in the label font")
    placed, x, left, right = [], 0, 0, 0
    for ch in text:
        bmp, ox, oy, adv = glyphs[ch]
        if bmp.size:
            placed.append((bmp, x + ox, oy))
            left, right = min(left, x + ox), max(right, x + ox + bmp.shape[1])
        x += adv
    width, height = max(max(right, x) - left, 1), atlas["height"]
    # an oversized canvas in the layout's coordinates, cropped to the
    # image at [0, width) × [0, height)
    pad = 16
    cov = np.zeros((height + 2 * pad, width + 2 * pad), np.int64)
    for bmp, gx, gy in placed:
        h, w = bmp.shape
        sub = cov[pad + gy:pad + gy + h, pad + gx:pad + gx + w]
        t = sub * (255 - bmp) + 128
        sub[...] = bmp + (((t >> 8) + t) >> 8)
    pixel = (255 - cov[pad:pad + height, pad:pad + width]).astype(np.uint8)
    arr = np.repeat(pixel[..., None], 3, axis=-1).astype(np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))


def add_label(image: np.ndarray, label: str, font_path: str | None = None,
              font_size: int = 24) -> np.ndarray:
    """Stack a label above a (3, H, W) image (`annotation.py:39-49`)."""
    return vcat(draw_label(label, font_path, font_size),
                np.asarray(image, np.float32), align="left", gap=4)
