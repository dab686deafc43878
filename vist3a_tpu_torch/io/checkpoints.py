"""Checkpoint and resume: the reference's three schemes on `torch.save`.

Port of `vist3a_tpu/io/checkpoints.py` (orbax there):
  1. stitching (`model_stitching_training.py:33-72,243-279`): per epoch
     `stitched_model_epoch_N.pt`, the exported set (the LoRA factors and
     the trained model tensors: stitch conv, cls and register tokens, the
     LoRA sites' biases), and `resume_checkpoint.pt` with the epoch, the
     step, the trainables and the AdamW state;
  2. VDM (`train_vdm.py:32-97,439-496`): `checkpoint-N/{lora, lora_ema,
     optim, ema_shadow}.pt` and `meta.json` (the step and the position of
     the run's host-side draws);
  3. the layer search's per-layer `.npz` artifacts
     (`find_layer_for_stitching.py:262-325`).

Every save is atomic: the file (or the `checkpoint-N` folder) is written
under a temporary name in the same folder and renamed into place.  The
files are the port's own `torch.save` archives: the JAX package's orbax
checkpoints cannot be read here, nor these there.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path

import numpy as np
import torch


def _atomic(path: Path, write) -> None:
    """write(tmp) then rename tmp → path."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    write(tmp)
    os.replace(tmp, path)


def _save_file(path, obj) -> None:
    _atomic(Path(path), lambda tmp: torch.save(obj, tmp))


def _load_file(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _detached(tree):
    """Nested dicts with every tensor detached (other values as they are)."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


# --------------------------------------------------------------------------- #
# scheme 1: stitching training                                                #
# --------------------------------------------------------------------------- #
def stitched_model_state(trainable: dict) -> dict:
    """The exported set of `save_checkpoint` (`model_stitching_training.py:
    57-72`): {"lora": {site: {"a", "b"}}, "model": {name: tensor}} of a
    `TrainState.trainable`, which holds exactly that set."""
    return _detached(trainable)


def save_stitching_checkpoint(save_dir, epoch: int, state) -> None:
    """Per-epoch save: the exported set and the whole resume state (the
    trainables, the AdamW state, the step)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    exported = stitched_model_state(state.trainable)
    _save_file(save_dir / f"stitched_model_epoch_{epoch}.pt", exported)
    _save_file(save_dir / "resume_checkpoint.pt",
              {"epoch": epoch, "step": state.step, "trainable": exported,
               "optimizer": state.optimizer.state_dict()})


def _copy_into(dst: dict, src: dict, what: str) -> None:
    """Copy the tensors of `src` into those of `dst`, in place; the two
    must hold the same names and shapes."""
    flat_dst, flat_src = _flatten(dst), _flatten(src)
    if flat_dst.keys() != flat_src.keys():
        raise KeyError(f"{what}: the checkpoint holds "
                       f"{sorted(flat_src.keys() ^ flat_dst.keys())[:10]} "
                       "where the state does not, or the reverse")
    with torch.no_grad():
        for k, t in flat_dst.items():
            t.copy_(flat_src[k])


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_stitching_checkpoint(save_dir, state):
    """Resume (`model_stitching_training.py:243-279`): the trainables, the
    AdamW state and the step restored into `state` in place.  Returns
    (epoch_start, state), epoch_start the saved epoch + 1."""
    ck = _load_file(Path(save_dir) / "resume_checkpoint.pt")
    _copy_into(state.trainable, ck["trainable"], "trainable")
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    return int(ck["epoch"]) + 1, state


# --------------------------------------------------------------------------- #
# scheme 2: VDM training                                                      #
# --------------------------------------------------------------------------- #
_CHECKPOINT = re.compile(r"^checkpoint-(\d+)$")


def save_vdm_checkpoint(save_dir, step: int, *, lora: dict, lora_ema: dict,
                        opt_state: dict, ema_shadow: dict,
                        meta: dict) -> str:
    """`checkpoint-{step}/` as `train_vdm.py:32-97` lays it out: the LoRA
    factors, their EMA cast like them (the reference's swap-save-swap,
    :57-69), the AdamW state, the fp32 EMA shadow and `meta.json`.  The
    folder is written whole under a temporary name, then renamed."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    root = save_dir / f"checkpoint-{step}"
    tmp = save_dir / f".checkpoint-{step}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    for name, tree in (("lora", lora), ("lora_ema", lora_ema),
                       ("optim", opt_state), ("ema_shadow", ema_shadow)):
        torch.save(_detached(tree), tmp / f"{name}.pt")
    (tmp / "meta.json").write_text(json.dumps(meta, default=str))
    if root.exists():
        shutil.rmtree(root)
    os.replace(tmp, root)
    return str(root)


def load_vdm_checkpoint(ckpt_dir):
    """(lora, lora_ema, opt_state, ema_shadow, meta) of a `checkpoint-N`
    folder."""
    root = Path(ckpt_dir)
    meta = json.loads((root / "meta.json").read_text())
    return (*(_load_file(root / f"{name}.pt")
              for name in ("lora", "lora_ema", "optim", "ema_shadow")),
            meta)


def latest_checkpoint(save_dir) -> str | None:
    """The `checkpoint-N` folder of `save_dir` with the largest N, or None
    (temporary folders of an unfinished save are not counted)."""
    root = Path(save_dir)
    if not root.is_dir():
        return None
    cands = [(int(m[1]), p) for p in root.iterdir()
             if p.is_dir() and (m := _CHECKPOINT.match(p.name))]
    return str(max(cands)[1]) if cands else None


# --------------------------------------------------------------------------- #
# scheme 3: search artifacts (host numpy, idempotent)                         #
# --------------------------------------------------------------------------- #
def save_search_artifact(path, tree: dict) -> None:
    flat = {k: np.asarray(v) for k, v in tree.items()}

    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
    _atomic(Path(path), write)


def load_search_artifact(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
