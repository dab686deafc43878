"""Checkpoint files → tensors: torch pickles and safetensors.

Port of `vist3a_tpu/io/load_weights.py`.  The reference ships torch
checkpoints (`anysplat_stitched.pth`, the AnySplat hub file, the Wan
diffusers shards, PEFT LoRA folders).  Unlike the JAX package, which casts
every float to fp32 numpy, the loaders here return CPU tensors in the
file's own dtype: a module casts when it loads them (`io/weight_import.py`),
so a bf16 file loaded into a bf16 module is rounded once, as there.

safetensors files are read by `load_safetensors`, which needs no package:
the format is an 8-byte little-endian header length, a JSON header
`{name: {"dtype", "shape", "data_offsets": [begin, end]}}` (offsets into
the bytes after the header; an optional `__metadata__` entry), then the raw
little-endian bytes.  Each tensor is read straight into its own aligned
buffer, BF16 included (numpy has no bfloat16).
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path

import torch

from vist3a_tpu_torch.io.checkpoints import _detached

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_torch_state_dict(path) -> dict:
    """.pt / .pth / .bin → {name: tensor} on the CPU, in the file's dtypes.
    The file is unpickled with `weights_only=True` (tensors and plain
    containers, no code); a {"state_dict": {...}} wrapper gives its inner
    dict; nested dicts (the stitched checkpoint's {"lora": {...},
    "stitching_layer": {...}, ...}) stay nested."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return _detached(obj)


def load_safetensors(path) -> dict[str, torch.Tensor]:
    """One .safetensors file → {name: CPU tensor} in the file's dtypes."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        for name, info in header.items():
            dtype = SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']}, which is not read here")
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            need = math.prod(shape) * dtype.itemsize
            if end - begin != need:
                raise ValueError(f"{path}: tensor {name!r} spans "
                                 f"{end - begin} bytes, its shape {shape} "
                                 f"needs {need}")
            raw = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(base + begin)
            if f.readinto(raw.numpy()) != end - begin:
                raise ValueError(f"{path}: truncated at tensor {name!r}")
            out[name] = raw.view(dtype).reshape(shape)
    return out


def load_sharded_safetensors(model_dir) -> dict[str, torch.Tensor]:
    """HF hub layout: `model.safetensors`, or the shards a
    `model.safetensors.index.json` names, or else every `*.safetensors` of
    the folder (diffusers' `diffusion_pytorch_model*.safetensors`, PEFT's
    `adapter_model.safetensors`)."""
    model_dir = Path(model_dir)
    single = model_dir / "model.safetensors"
    if single.exists():
        return load_safetensors(single)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        shards = set(json.loads(index.read_text())["weight_map"].values())
        files = [model_dir / s for s in sorted(shards)]
    else:
        files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors found under {model_dir}")
    out: dict[str, torch.Tensor] = {}
    for f in files:
        out.update(load_safetensors(f))
    return out
