"""The port's checkpoint readers (`vist3a_tpu_torch/io/load_weights.py`).

The safetensors reader needs no package; here it reads files that the
`safetensors` package writes — F32, F16, BF16 and I64, one file, a sharded
folder with its index, a folder of shards without one — and must return
the same tensors bit for bit, in the file's dtype.  The torch-pickle
loader must unwrap `state_dict` as the JAX package's does and keep nested
dicts and the file's dtypes (the JAX package casts floats to fp32 numpy:
compared in fp32, exactly).  Also: no module of the port imports JAX, the
JAX package, `safetensors` or `transformers` at import time.
"""

import ast
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from vist3a_tpu.io import load_weights as jlw
from vist3a_tpu_torch.io import load_weights as tlw

safetensors_torch = pytest.importorskip("safetensors.torch")

PORT = Path(__file__).resolve().parent.parent / "vist3a_tpu_torch"


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.f32": torch.randn(3, 5, generator=g),
        "b.f16": torch.randn(7, generator=g).half(),
        "c.bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "d.i64": torch.randint(-2 ** 40, 2 ** 40, (6,), generator=g),
        "e.scalar": torch.tensor(3.5),
        "f.odd_f16": torch.randn(3, generator=g).half(),   # 6 bytes
        "g.after_odd": torch.randn(2, 2, generator=g),     # unaligned start
    }


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


def test_single_file_every_dtype(tmp_path):
    want = _tensors()
    safetensors_torch.save_file(want, tmp_path / "model.safetensors",
                                metadata={"format": "pt"})
    _same(tlw.load_safetensors(tmp_path / "model.safetensors"), want)
    _same(tlw.load_sharded_safetensors(tmp_path), want)


def test_sharded_with_index_and_without(tmp_path):
    want = _tensors(1)
    names = sorted(want)
    shards = {"model-00001-of-00002.safetensors": names[:3],
              "model-00002-of-00002.safetensors": names[3:]}
    index = {"metadata": {}, "weight_map": {}}
    for shard, keys in shards.items():
        safetensors_torch.save_file({k: want[k] for k in keys},
                                    tmp_path / shard)
        index["weight_map"].update({k: shard for k in keys})
    # a stray file the index does not name is not read
    safetensors_torch.save_file({"stray": torch.zeros(1)},
                                tmp_path / "other.safetensors")
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))
    _same(tlw.load_sharded_safetensors(tmp_path), want)

    (tmp_path / "model.safetensors.index.json").unlink()
    (tmp_path / "other.safetensors").unlink()
    _same(tlw.load_sharded_safetensors(tmp_path), want)


def test_safetensors_matches_the_jax_loader_in_fp32(tmp_path):
    # the JAX loader reads through safetensors.numpy, which has no bf16
    want = {k: v for k, v in _tensors(2).items()
            if v.is_floating_point() and v.dtype != torch.bfloat16}
    safetensors_torch.save_file(want, tmp_path / "model.safetensors")
    got = tlw.load_sharded_safetensors(tmp_path)
    ref = jlw.load_sharded_safetensors(tmp_path)
    assert got.keys() == ref.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(ref[k], np.float32))


def test_bad_files_raise(tmp_path):
    safetensors_torch.save_file({"x": torch.zeros(4)},
                                tmp_path / "model.safetensors")
    raw = (tmp_path / "model.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="truncated"):
        tlw.load_safetensors(tmp_path / "cut.safetensors")
    with pytest.raises(FileNotFoundError):
        tlw.load_sharded_safetensors(tmp_path / "nothing_here")


def test_torch_state_dict_unwraps_and_keeps_dtypes(tmp_path):
    g = torch.Generator().manual_seed(3)
    inner = {"w": torch.randn(4, 3, generator=g),
             "h": torch.randn(5, generator=g).bfloat16(),
             "n": torch.arange(3)}
    nested = {"lora": {"x.lora_A": torch.randn(2, 3, generator=g)},
              "stitching_layer": {"weight": torch.randn(2, 2, generator=g)},
              "cls_token": torch.randn(1, 1, 4, generator=g)}
    torch.save({"state_dict": inner}, tmp_path / "wrapped.pth")
    torch.save(nested, tmp_path / "nested.pth")
    torch.save(torch.nn.Linear(3, 2).state_dict(), tmp_path / "plain.pt")
    torch.save(torch.nn.Linear(3, 2), tmp_path / "module.pt")

    got = tlw.load_torch_state_dict(tmp_path / "wrapped.pth")
    ref = jlw.load_torch_state_dict(tmp_path / "wrapped.pth")
    assert got.keys() == inner.keys() == ref.keys()
    for k, v in inner.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)
        np.testing.assert_array_equal(
            got[k].float().numpy() if v.is_floating_point()
            else got[k].numpy(), ref[k])

    got = tlw.load_torch_state_dict(tmp_path / "nested.pth")
    assert torch.equal(got["lora"]["x.lora_A"], nested["lora"]["x.lora_A"])
    assert torch.equal(got["stitching_layer"]["weight"],
                       nested["stitching_layer"]["weight"])
    got = tlw.load_torch_state_dict(tmp_path / "plain.pt")
    assert set(got) == {"weight", "bias"}
    # a pickled module needs code to unpickle: refused, not run
    with pytest.raises(pickle.UnpicklingError):
        tlw.load_torch_state_dict(tmp_path / "module.pt")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_port_imports_no_jax_nor_optional_packages():
    """Every module of the port and `chip_smoke.py`: no `jax`, no
    `vist3a_tpu` (the JAX package), no `safetensors`, and `transformers`
    nowhere at module level (only inside `hf_tokenizer`)."""
    banned = ("jax", "vist3a_tpu", "safetensors")
    for path in [*sorted(PORT.rglob("*.py")), PORT.parent / "chip_smoke.py"]:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in banned, f"{path}: imports {name}"
        top = ast.parse(path.read_text()).body
        for node in top:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any((n or "").startswith("transformers")
                               for n in names), f"{path}: {names}"
