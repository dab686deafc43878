"""The port's visualization suite (`vist3a_tpu_torch/viz`) against the JAX
package's (`vist3a_tpu/viz`).

Inputs are made with numpy from a seed.  Tolerances, with their reasons:
  * layout, colours, `resize_image`, `apply_color_map_2d` and the labels:
    host numpy (and OpenCV) on both sides, bit for bit;
  * `apply_color_map`: every named map of the installed matplotlib, and the
    JAX package's `apply_color_map` (which calls matplotlib), bit for bit,
    on numpy arrays and on tensors; NaN black;
  * labels: the port's glyph atlas against JAX's Pillow rendering, bit for
    bit, on the labels `render_projections` and `draw_cameras` write and on
    others (`tools/torch_label_atlas.py` checks 11,120 more);
  * drawing: fp32 on both sides, the products summed in another order, so
    within 1e-5 (alphas in [0, 1], colours in [0, 1]);
  * `render_projections`: the same float64 cameras, then the render of
    `tests/test_torch_raster.py` (JAX's Pallas composite in interpret mode,
    the port's plain composite): atol 2e-5 on colour, the labels exact.
The structural properties that `tests/test_viz.py` asserts of the JAX
package are asserted of the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vist3a_tpu.viz as jviz
import vist3a_tpu_torch.viz as tviz
from test_viz import _toy_gaussians
from vist3a_tpu.viz import color_map as jcm
from vist3a_tpu.viz import layout as jlayout
from vist3a_tpu_torch.nn.gaussians import Gaussians as TGaussians
from vist3a_tpu_torch.viz import color_map as tcm
from vist3a_tpu_torch.viz import drawing as tdraw
from vist3a_tpu_torch.viz import layout as tlayout

DRAW_ATOL = 1e-5
RENDER_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# layout                                                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fn,align,gap,gap_color", [
    ("hcat", "start", 8, 1), ("hcat", "center", 3, 0.5),
    ("hcat", "bottom", 0, (0.1, 0.2, 0.3)), ("vcat", "left", 4, 1),
    ("vcat", "center", 2, 0), ("vcat", "right", 5, (1.0, 0.0, 0.5))])
def test_cat_equals_jax(rng, fn, align, gap, gap_color):
    ims = [rng.uniform(0, 1, (3, int(h), int(w))).astype(np.float32)
           for h, w in rng.integers(1, 12, (3, 2))]
    _same(getattr(tviz, fn)(*ims, align=align, gap=gap, gap_color=gap_color),
          getattr(jviz, fn)(*ims, align=align, gap=gap, gap_color=gap_color))


@pytest.mark.parametrize("axis,main,cross", [
    ("horizontal", "end", "center"), ("vertical", "start", "end"),
    ("horizontal", "center", "start")])
def test_overlay_and_border_equal_jax(rng, axis, main, cross):
    base = rng.uniform(0, 1, (3, 9, 11)).astype(np.float32)
    child = rng.uniform(0, 1, (3, 4, 5)).astype(np.float32)
    _same(tviz.overlay(base, child, axis, main, cross),
          jviz.overlay(base, child, axis, main, cross))
    _same(tviz.add_border(child, 3, (0.2, 0.4, 0.6)),
          jviz.add_border(child, 3, (0.2, 0.4, 0.6)))


@pytest.mark.parametrize("kw", [{"shape": (7, 9)}, {"width": 20},
                                {"height": 5}, {"shape": (31, 17)}])
def test_resize_image_equals_jax(rng, kw):
    im = rng.uniform(0, 1, (3, 13, 15)).astype(np.float32)
    _same(tlayout.resize_image(im, **kw), jlayout.resize_image(im, **kw))


def test_hcat_vcat_shapes_and_gap():
    a = np.zeros((3, 10, 4), np.float32)
    b = np.zeros((3, 6, 8), np.float32)
    h = tviz.hcat(a, b, gap=8)
    assert h.shape == (3, 10, 4 + 8 + 8)
    np.testing.assert_allclose(h[:, :, 4:12], 1.0)
    v = tviz.vcat(a, b, gap=2, gap_color=0)
    assert v.shape == (3, 10 + 2 + 6, 8)
    np.testing.assert_allclose(v[:, 10:12, :], 0.0)
    tall = np.zeros((3, 8, 2), np.float32)
    short = np.full((3, 4, 2), 0.5, np.float32)
    top = tviz.hcat(tall, short, align="top", gap=0)
    assert np.allclose(top[:, :4, 2:], 0.5) and np.allclose(top[:, 4:, 2:], 1)
    out = tviz.add_border(np.zeros((3, 4, 4), np.float32), border=2)
    assert out.shape == (3, 8, 8) and np.all(out[:, 2:6, 2:6] == 0.0)


def test_pad_equals_jax(rng):
    ims = [rng.uniform(0, 1, (3, 4, 6)).astype(np.float32),
           rng.uniform(0, 1, (3, 8, 2)).astype(np.float32)]
    for got, want in zip(tviz.pad(ims), jviz.pad(ims)):
        _same(got, want)
    assert tviz.pad(ims)[0][0, 5, 0] == 1.0


# --------------------------------------------------------------------------- #
# colours and colour maps                                                     #
# --------------------------------------------------------------------------- #
def test_distinct_colors_equal_jax():
    for i in range(50):
        assert tviz.get_distinct_color(i) == jviz.get_distinct_color(i)
    assert tviz.get_distinct_color(22) == tviz.get_distinct_color(0)


def _scalars(rng):
    return np.concatenate([rng.uniform(-0.2, 1.2, 4000),
                           np.linspace(0.0, 1.0, 1537),
                           [np.nan, 0.0, 1.0, np.nextafter(1.0, 0.0)]])


def test_every_named_map_is_matplotlibs(rng):
    """All 180 maps (the `_r` ones the reversed tables), on numpy and on
    tensors, equal `matplotlib.colormaps[name]` in float32."""
    import matplotlib

    x = _scalars(rng)
    names = tcm.color_map_names()
    assert sorted(names) == sorted(matplotlib.colormaps)
    for name in names:
        want = matplotlib.colormaps[name](np.clip(x, 0, 1))[..., :3] \
            .astype(np.float32)
        _same(tcm.apply_color_map(x, name), want)
        _same(tcm.apply_color_map(torch.from_numpy(x), name).numpy(), want)
    with pytest.raises(KeyError, match="not a known"):
        tcm.apply_color_map(x, "no_such_map")


@pytest.mark.parametrize("name", ["inferno", "turbo", "viridis_r", "tab10",
                                  "gray"])
def test_apply_color_map_equals_jax(rng, name):
    x = _scalars(rng)[1:].reshape(-1, 4, 5)
    img = rng.uniform(0, 1, (2, 6, 9))
    _same(tviz.apply_color_map(x, name), jviz.apply_color_map(x, name))
    _same(tviz.apply_color_map_to_image(img, name),
          jviz.apply_color_map_to_image(img, name))
    _same(tviz.apply_color_map_to_image(torch.from_numpy(img), name)
          .numpy(), jviz.apply_color_map_to_image(img, name))
    # a scalar (matplotlib returns a tuple there, which the JAX package
    # then fails to slice): the entry of a one-element array
    _same(tviz.apply_color_map(np.float32(0.3), name),
          jviz.apply_color_map(np.float32([0.3]), name)[0])


def test_color_map_2d_equals_jax(rng):
    x, y = rng.uniform(-0.1, 1.1, (2, 40, 30))
    _same(tviz.apply_color_map_2d(x, y), jviz.apply_color_map_2d(x, y))
    rgb = rng.uniform(0, 1, (32, 3))
    _same(tcm._lab_to_srgb(tcm._srgb_to_lab(rgb)),
          jcm._lab_to_srgb(jcm._srgb_to_lab(rgb)))
    np.testing.assert_allclose(tviz.apply_color_map_2d(1.0, 1.0),
                               np.array([189, 0, 0]) / 255.0, atol=1e-6)


# --------------------------------------------------------------------------- #
# labels                                                                      #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("text", [
    "XY Projection", "YZ Projection", "ZX Projection",
    "XY Projection (step 120)", "hello", "iii", "WWW", " lead & trail ",
    "a_b{c}|~ j,;/\\x", tviz.annotation.EXPECTED_CHARACTERS])
def test_labels_are_pillows(text):
    _same(tviz.draw_label(text), jviz.draw_label(text))
    im = np.random.default_rng(1).uniform(0, 1, (3, 9, 14)).astype(np.float32)
    _same(tviz.add_label(im, text), jviz.add_label(im, text))


def test_label_rules():
    assert tviz.draw_label("iii").shape[1] == tviz.draw_label("WWW").shape[1]
    lab = tviz.draw_label("hello")
    assert lab.min() < 0.5 and lab.max() == 1.0
    with pytest.raises(ValueError, match="no glyph"):
        tviz.draw_label("café")
    with pytest.raises(NotImplementedError):
        tviz.draw_label("x", font_path=__file__)
    _same(tviz.draw_label(""), jviz.draw_label(""))


# --------------------------------------------------------------------------- #
# drawing                                                                     #
# --------------------------------------------------------------------------- #
def _close(got, want, atol=DRAW_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("cap", ["round", "square", "butt"])
def test_draw_lines_equals_jax(rng, cap):
    im = rng.uniform(0, 1, (3, 24, 31)).astype(np.float32)
    n = 7
    start, end = rng.uniform(-4, 34, (2, n, 2)).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    width = rng.uniform(0.5, 5.0, (n,)).astype(np.float32)
    for w in (width[0], 2):
        _close(tviz.draw_lines(im, start, end, color, w, cap=cap,
                               device="cpu"),
               jviz.draw_lines(jnp.asarray(im), start, end, color, w,
                               cap=cap))
    ranges = {"x_range": (-1.5, 2.0), "y_range": (0.25, 1.0)}
    wstart = rng.uniform(-1, 2, (n, 2))
    wend = rng.uniform(-1, 2, (n, 2))
    _close(tviz.draw_lines(im, wstart, wend, 0.5, 3, cap=cap, device="cpu",
                           **ranges),
           jviz.draw_lines(jnp.asarray(im), wstart, wend, 0.5, 3, cap=cap,
                           **ranges))


def test_draw_lines_paints_in_index_order_in_chunks(rng, monkeypatch):
    """Chunks of one primitive give the same image (the top colour is the
    last primitive's with alpha > 0, whichever chunk held it)."""
    im = np.zeros((3, 16, 16), np.float32)
    start, end = rng.uniform(0, 16, (2, 9, 2)).astype(np.float32)
    color = rng.uniform(0, 1, (9, 3)).astype(np.float32)
    whole = tviz.draw_lines(im, start, end, color, 3, device="cpu")
    monkeypatch.setattr(tdraw, "_CHUNK_PIXELS", 16 * 16)
    np.testing.assert_array_equal(
        tviz.draw_lines(im, start, end, color, 3, device="cpu").numpy(),
        whole.numpy())
    out = tviz.draw_lines(np.zeros((3, 32, 32), np.float32),
                          [[4.0, 16.0], [16.0, 4.0]],
                          [[28.0, 16.0], [16.0, 28.0]],
                          color=[[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], width=3,
                          device="cpu").numpy()
    np.testing.assert_allclose(out[:, 16, 16], [0.0, 0.0, 1.0], atol=1e-6)


def test_draw_points_equals_jax(rng):
    im = rng.uniform(0, 1, (3, 20, 26)).astype(np.float32)
    pts = rng.uniform(0, 26, (6, 2)).astype(np.float32)
    color = rng.uniform(0, 1, (6, 3)).astype(np.float32)
    _close(tviz.draw_points(im, pts, color, 4, 1.5, device="cpu"),
           jviz.draw_points(jnp.asarray(im), pts, color, 4, 1.5))
    _close(tviz.draw_points(im, [[13.0, 10.0]], 1.0, 6, device="cpu"),
           jviz.draw_points(jnp.asarray(im), [[13.0, 10.0]], 1.0, 6))
    out = tviz.draw_points(np.zeros((3, 32, 32), np.float32), [[16.0, 16.0]],
                           color=1.0, radius=8, inner_radius=4,
                           device="cpu").numpy()
    assert out[0, 16, 16] == 0.0 and out[0, 16, 10] == 1.0


def _cameras(b=3):
    extr = np.tile(np.eye(4), (b, 1, 1))
    extr[:, 0, 3] = np.linspace(-0.5, 0.5, b)
    extr[:, 2, 3] = np.linspace(0.0, 0.3, b)
    intr = np.tile(np.eye(3), (b, 1, 1))
    intr[:, 0, 0] = intr[:, 1, 1] = 1.2
    intr[:, 0, 2] = intr[:, 1, 2] = 0.5
    return extr, intr


def test_draw_cameras_equals_jax():
    extr, intr = _cameras()
    color = np.asarray([tviz.get_distinct_color(i) for i in range(3)],
                       np.float32)
    for near, far in ((0.1, 2.0), (None, None)):
        got = tviz.draw_cameras(48, extr, intr, color, near=near, far=far,
                                device="cpu")
        want = jviz.draw_cameras(48, extr, intr, color, near=near, far=far)
        _close(got, want)
        assert got.shape[:2] == (3, 3) and got.shape[2] >= 48
    _same(tdraw.unproject_frustum_corners(extr, intr, np.full(3, 0.7)),
          jviz.drawing.unproject_frustum_corners(extr, intr,
                                                 np.full(3, 0.7)))


# --------------------------------------------------------------------------- #
# 3-D validation views                                                        #
# --------------------------------------------------------------------------- #
def _both_gaussians(**kw):
    jg = _toy_gaussians(**kw)
    return jg, TGaussians(*(torch.from_numpy(np.array(x)) for x in jg))


@pytest.mark.parametrize("label", [False, True])
def test_render_projections_equals_jax(label):
    jg, tg = _both_gaussians()
    want = jviz.render_projections(jg, resolution=32, draw_label=label,
                                   extra_label="(test)")
    got = tviz.render_projections(tg, resolution=32, draw_label=label,
                                  extra_label="(test)", device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want, RENDER_ATOL)
    if label:
        # the label rows above the 4-pixel gap are the same pixels
        np.testing.assert_array_equal(got[..., :want.shape[3] - 36, :],
                                      want[..., :want.shape[3] - 36, :])
    else:
        # pad slots at 50 are opacity 0 and do not stretch the box
        assert got[0, :, :, 16, 16].max() > 0.05


def test_projection_cameras_are_jaxs_and_empty_scenes_render():
    """An entry with no live Gaussian takes the unit box, as in JAX."""
    jg, tg = _both_gaussians(g=8, g_pad=0)
    dead = tg._replace(opacities=torch.zeros_like(tg.opacities))
    out = tviz.render_projections(dead, resolution=16, draw_label=False,
                                  device="cpu")
    assert out.shape == (1, 3, 3, 16, 16) and np.all(out == 0.0)
    cams = tviz.validation_in_3d.projection_cameras(tg)
    assert [name for _, _, name in cams] == [
        "YZ Projection", "ZX Projection", "XY Projection"]
    for c2w, k, _ in cams:
        assert c2w.dtype == np.float64 and k.shape == (1, 3, 3)


def test_render_camera_poses_equals_jax():
    def views(n, off):
        extr = np.tile(np.eye(4), (1, n, 1, 1))
        extr[0, :, 0, 3] = off + 0.1 * np.arange(n)
        intr = np.tile(np.eye(3), (1, n, 1, 1))
        intr[0, :, 0, 2] = intr[0, :, 1, 2] = 0.5
        return {"extrinsics": extr, "intrinsics": intr,
                "near": np.full((1, n), 0.05), "far": np.full((1, n), 1.0)}

    batch = {"context": views(2, -0.3), "target": views(1, 0.3)}
    got = tviz.render_camera_poses(batch, resolution=40, device="cpu")
    _close(got, jviz.render_camera_poses(batch, resolution=40))
    assert got.shape[:2] == (3, 3) and np.isfinite(got).all()
    assert got.max() > 0.0


def test_viz_runs_without_pillow_nor_matplotlib(tmp_path):
    """The labels, colour maps and drawing in a process where Pillow,
    matplotlib and JAX cannot be imported (the card machine has neither of
    the first two): the same pixels as here."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "for m in ('PIL', 'matplotlib', 'jax', 'vist3a_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import vist3a_tpu_torch.viz as v\n"
        "lab = v.add_label(np.zeros((3, 4, 70), np.float32), 'XY Projection')\n"
        "cm = v.apply_color_map(np.linspace(0, 1, 9), 'magma_r')\n"
        "cams = v.draw_cameras(32, *[np.asarray(x) for x in CAMS],\n"
        "                      np.ones((3, 3), np.float32), near=0.1, far=2.0,\n"
        "                      device='cpu')\n"
        "np.savez(OUT, lab=lab, cm=cm, cams=cams)\n")
    out = tmp_path / "viz.npz"
    extr, intr = _cameras()
    code = code.replace("CAMS", repr((extr.tolist(), intr.tolist()))) \
        .replace("OUT", repr(str(out)))
    run = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    with np.load(out) as got:
        _same(got["lab"], tviz.add_label(np.zeros((3, 4, 70), np.float32),
                                         "XY Projection"))
        _same(got["cm"], tviz.apply_color_map(np.linspace(0, 1, 9),
                                              "magma_r"))
        _same(got["cams"], tviz.draw_cameras(
            32, extr, intr, np.ones((3, 3), np.float32), near=0.1, far=2.0,
            device="cpu"))
