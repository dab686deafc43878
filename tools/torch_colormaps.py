#!/usr/bin/env python3
"""Write matplotlib's named colour maps to `vist3a_tpu_torch/viz/colormaps.npz`.

    python tools/torch_colormaps.py

The port colours scalar fields without matplotlib (`viz/color_map.py`), so
it carries the tables: every registered map whose name does not end in
`_r`, sampled at its own N (`cmap(np.arange(N))`, the RGB of its lookup
table) and stored in float32, the dtype `apply_color_map` returns.  A `_r`
map is its base map's table reversed; the script checks that this, and the
black "bad" colour of NaN, hold for every map in float32, and records the
matplotlib version.
"""

from __future__ import annotations

from pathlib import Path

import matplotlib
import numpy as np

OUT = (Path(__file__).resolve().parents[1] / "vist3a_tpu_torch" / "viz"
       / "colormaps.npz")


def tables() -> dict[str, np.ndarray]:
    names = sorted(n for n in matplotlib.colormaps if not n.endswith("_r"))
    out = {}
    for name in names:
        cmap = matplotlib.colormaps[name]
        lut = cmap(np.arange(cmap.N))[:, :3].astype(np.float32)
        rev = matplotlib.colormaps[name + "_r"]
        if not np.array_equal(rev(np.arange(rev.N))[:, :3].astype(np.float32),
                              lut[::-1]):
            raise SystemExit(f"{name}_r is not {name}'s table reversed")
        if np.any(cmap(np.nan)[:3]):
            raise SystemExit(f"{name}: NaN is not black")
        out[name] = lut
    return out


def main() -> None:
    out = tables()
    np.savez_compressed(OUT, __matplotlib__=np.array(matplotlib.__version__),
                        **out)
    print(f"{len(out)} maps (and as many _r) from matplotlib "
          f"{matplotlib.__version__} → {OUT} ({OUT.stat().st_size} B)")


if __name__ == "__main__":
    main()
