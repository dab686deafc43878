#!/usr/bin/env python3
"""Write the label font's glyph atlas to `vist3a_tpu_torch/viz/label_font.npz`.

    python tools/torch_label_atlas.py

The JAX package draws labels with Pillow's `ImageFont.load_default()`, which
in Pillow 12.1.0 is the bundled Aileron Regular at size 10, rendered by
FreeType with antialiasing and laid out by Pillow's basic layout.  The port
draws them without Pillow (`viz/annotation.py`), so it carries what that
layout reads for `EXPECTED_CHARACTERS` and the space: each glyph's 8-bit
coverage bitmap and its origin as `getmask2` returns them, and its advance;
and the label height, the height of `getbbox(EXPECTED_CHARACTERS)`.

The script checks what the atlas leaves out: whole-pixel advances and no
kerning between any two of the characters.  Then it draws every label of
one and two characters and 2,000 random ones both ways and fails unless
they agree bit for bit.
"""

from __future__ import annotations

import itertools
import random
import sys
from pathlib import Path

import numpy as np
import PIL
from PIL import Image, ImageDraw, ImageFont

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "vist3a_tpu_torch" / "viz" / "label_font.npz"


def pillow_label(font, text: str, expected: str) -> np.ndarray:
    """The JAX package's `draw_label`, as float32 (3, H, W)."""
    left, _, right, _ = font.getbbox(text)
    width = max(right - left, 1)
    _, top, _, bottom = font.getbbox(expected)
    height = max(bottom - top, 1)
    image = Image.new("RGB", (width, height), color="white")
    ImageDraw.Draw(image).text((0, 0), text, font=font, fill="black")
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))


def atlas(font, chars: str, expected: str) -> dict:
    bitmaps, start, shape, origin, advance = [], [0], [], [], []
    for ch in chars:
        mask, (ox, oy) = font.getmask2(ch, mode="L")
        w, h = mask.size
        bmp = np.array(mask, dtype=np.uint8).reshape(h, w) if w * h else \
            np.zeros((h, w), np.uint8)
        adv = font.getlength(ch)
        if adv != int(adv):
            raise SystemExit(f"{ch!r}: advance {adv} is not whole pixels")
        bitmaps.append(bmp.reshape(-1))
        start.append(start[-1] + bmp.size)
        shape.append((h, w))
        origin.append((ox, oy))
        advance.append(int(adv))
    for a, b in itertools.product(chars, repeat=2):
        if font.getlength(a + b) != font.getlength(a) + font.getlength(b):
            raise SystemExit(f"{a + b!r} is kerned; the atlas has no kerning")
    _, top, _, bottom = font.getbbox(expected)
    return {"chars": np.array([ord(c) for c in chars], np.int32),
            "bitmaps": np.concatenate(bitmaps),
            "start": np.array(start, np.int64),
            "shape": np.array(shape, np.int32),
            "origin": np.array(origin, np.int32),
            "advance": np.array(advance, np.int32),
            "height": np.array(max(bottom - top, 1), np.int32),
            "source": np.array(f"Pillow {PIL.__version__} load_default(): "
                               f"{' '.join(font.getname())} {font.size}")}


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from vist3a_tpu_torch.viz import annotation

    font = ImageFont.load_default()
    expected = annotation.EXPECTED_CHARACTERS
    chars = expected + " "
    np.savez_compressed(OUT, **atlas(font, chars, expected))
    annotation._atlas.cache_clear()
    rng = random.Random(0)
    texts = [*chars, *("".join(p) for p in itertools.product(chars, repeat=2)),
             *("".join(rng.choice(chars) for _ in range(rng.randint(1, 40)))
               for _ in range(2000))]
    bad = [t for t in texts if not np.array_equal(
        annotation.draw_label(t), pillow_label(font, t, expected))]
    if bad:
        raise SystemExit(f"{len(bad)} of {len(texts)} labels differ from "
                         f"Pillow's, first {bad[:5]}")
    print(f"{len(chars)} glyphs → {OUT} ({OUT.stat().st_size} B); "
          f"{len(texts)} labels equal to Pillow's bit for bit")


if __name__ == "__main__":
    main()
