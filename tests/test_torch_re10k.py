"""The RE10K evaluation data of the port (`eval/re10k.py`) against Pillow
and the JAX package's `vist3a_tpu/eval/re10k.py`, on the CPU.

  * `lanczos_resize` (Pillow's 8-bit two-pass Lanczos written in numpy)
    equals `PIL.Image.resize(..., Image.LANCZOS)` byte for byte: down- and
    up-scales, odd sizes, one axis kept, and RE10K's 640×360 → 512 → 448
    chain, on random and on smooth images;
  * `rescale_image_w_crop` gives JAX's images and intrinsics exactly;
  * `Re10KNVSDataset.get_data` gives JAX's arrays exactly, with Pillow and
    with Pillow blocked (the OpenCV decode).
"""

import json
import sys

import numpy as np
import pytest
from PIL import Image

from vist3a_tpu.eval import re10k as jre
from vist3a_tpu_torch.eval import re10k as tre

SIZES = [((360, 640), (910, 512)), ((512, 512), (448, 448)),
         ((37, 53), (20, 11)), ((37, 53), (101, 77)), ((7, 9), (3, 30)),
         ((64, 64), (64, 30)), ((100, 33), (33, 100)), ((1, 5), (3, 1))]


def _image(hw, kind: int, seed: int = 0) -> np.ndarray:
    h, w = hw
    if kind == 0:
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                    dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(3 * xx + yy) % 256, (xx * yy) % 256,
                     (255 * xx // max(w - 1, 1))], -1).astype(np.uint8)


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("hw,size", SIZES)
def test_lanczos_equals_pillow(hw, size, kind):
    img = _image(hw, kind)
    want = np.asarray(Image.fromarray(img).resize(size,
                                                  resample=Image.LANCZOS))
    got = tre.lanczos_resize(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,widths", [((360, 640), (512, 448)),
                                       ((120, 160), (64, 56)),
                                       ((97, 61), (50, 41))])
def test_rescale_image_w_crop_equals_jax(hw, widths):
    img = _image(hw, 0, seed=1)
    k = np.array([[0.9 * hw[1], 0, hw[1] / 2], [0, 0.9 * hw[1], hw[0] / 2],
                  [0, 0, 1]])
    jff, jk, jvae = jre.rescale_image_w_crop(Image.fromarray(img), k,
                                             *widths)
    ff, kk, vae = tre.rescale_image_w_crop(img, k, *widths)
    np.testing.assert_array_equal(ff, np.asarray(jff))
    np.testing.assert_array_equal(vae, np.asarray(jvae))
    np.testing.assert_array_equal(kk, jk)
    assert ff.shape == (widths[1],) * 2 + (3,)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("re10k")
    rng = np.random.default_rng(2)
    for seq in ("seq_a", "seq_b"):
        (root / seq / "images").mkdir(parents=True)
        annos = []
        for i in range(5):
            name = f"images/frame_{i:04d}.png"
            Image.fromarray(rng.integers(0, 255, (72, 96, 3), np.uint8)
                            ).save(root / seq / name)
            ex = np.eye(4)[:3]
            ex[0, 3] = 0.1 * i
            annos.append({"idx": i, "filepath": f"{seq}/{name}",
                          "intrinsics": [[120.0, 0, 48], [0, 120.0, 36],
                                         [0, 0, 1]],
                          "extrinsics": ex.tolist()})
        (root / seq / "annotations.json").write_text(json.dumps(annos))
    return root


@pytest.mark.parametrize("pil", [True, False])
def test_get_data_equals_jax(tree, monkeypatch, pil):
    want = jre.Re10KNVSDataset(str(tree), load_img_size=64,
                               feedforward_img_size=56).get_data(
        sequence_name="seq_b", ids=[4, 0, 2])
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)   # `import PIL` fails
    ds = tre.Re10KNVSDataset(str(tree), load_img_size=64,
                             feedforward_img_size=56)
    assert len(ds) == 2 and ds.get_seq_framenum("seq_a") == 5
    got = ds.get_data(sequence_name="seq_b", ids=[4, 0, 2])
    assert got.keys() == want.keys()
    for k in ("images", "vae_images", "extrs", "intrs", "ind"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["seq_id"], got["n"], got["image_paths"]) == \
        (want["seq_id"], want["n"], want["image_paths"])
