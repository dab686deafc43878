"""Distinct colour palette for multi-entity plots.

Port of `vist3a_tpu/viz/colors.py` (the reference's
`src/visualization/colors.py`): the sashamaps 20-colour palette plus black
and white, cycled by index, parsed from hex without Pillow.
"""

from __future__ import annotations

# https://sashamaps.net/docs/resources/20-colors/ (`colors.py:4-27`)
DISTINCT_COLORS = [
    "#e6194b", "#3cb44b", "#ffe119", "#4363d8", "#f58231", "#911eb4",
    "#46f0f0", "#f032e6", "#bcf60c", "#fabebe", "#008080", "#e6beff",
    "#9a6324", "#fffac8", "#800000", "#aaffc3", "#808000", "#ffd8b1",
    "#000075", "#808080", "#ffffff", "#000000",
]


def get_distinct_color(index: int) -> tuple[float, float, float]:
    """Cycle the palette; returns floats in [0,1] (`colors.py:30-32`)."""
    hx = DISTINCT_COLORS[index % len(DISTINCT_COLORS)].lstrip("#")
    return tuple(int(hx[i:i + 2], 16) / 255.0 for i in (0, 2, 4))
