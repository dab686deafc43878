"""What the harness, its drivers and the reference share: the files of a
cell and a configuration, the dataclass views of a configuration, the
weights drawn from the seed, the stand-in tokenizer and the prompts.

Nothing here imports the program or the reference: both sides receive what
this module makes from the seed.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import importlib.util
import json
import zlib
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a draw of at most this many elements per call: large calls, and a bounded
# extra buffer beside the parameters while they are filled
CHUNK = 1 << 28


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    """Cell `name`: its entry in BENCHMARK.json (configuration, traffic,
    chips), the limits of `cells/<name>.json`, and the traffic mix's
    parameters, `traffic/<traffic>.json`, under "traffic_params"."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    return {**entry,
            "limits": load_json(HERE / "cells" / f"{name}.json")["limits"],
            "traffic_params": load_json(HERE / "traffic"
                                        / f"{entry['traffic']}.json")}


def config_file(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_module(path: Path, name: str):
    """A Python file of the benchmark by path (its names may hold '.' and
    '-', which an import statement does not take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def as_tuples(x):
    if isinstance(x, list):
        return tuple(as_tuples(v) for v in x)
    return x


def from_dict(default, values: dict):
    """A frozen dataclass like `default` with `values` (a configuration
    file's JSON) in its fields; nested dataclass fields recurse, lists
    become tuples.  A key the dataclass lacks raises."""
    fields = {f.name for f in dataclasses.fields(default)}
    unknown = set(values) - fields
    if unknown:
        raise KeyError(f"{type(default).__name__} has no fields {unknown}")
    kw = {}
    for key, val in values.items():
        cur = getattr(default, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kw[key] = from_dict(cur, val)
        else:
            kw[key] = as_tuples(val)
    return dataclasses.replace(default, **kw)


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A host generator from the run's seed (any non-negative integer)."""
    return np.random.default_rng([seed, *salt])


def torch_seed(seed: int, *salt: int) -> int:
    """A 63-bit torch seed from the run's seed and a salt."""
    return int(rng(seed, *salt).integers(0, 2 ** 63 - 1))


# --------------------------------------------------------------------------- #
# weights                                                                     #
# --------------------------------------------------------------------------- #

def _rule(name: str, p: torch.Tensor, overrides: list) -> dict:
    """The distribution of parameter `name`: the first override that
    matches, else by shape — linear and conv weights N(0, 1/fan_in), 1-D
    scales (norms, LayerScale) 1 + N(0, 0.02²), biases N(0, 0.02²)."""
    for o in overrides:
        if fnmatch.fnmatchcase(name, o["match"]):
            return o
    if name.endswith("bias"):
        return {"std": 0.02}
    if p.ndim <= 1:
        return {"std": 0.02, "mean": 1.0}
    return {"std": float(np.prod(p.shape[1:])) ** -0.5}


class WeightStream:
    """The seed's parameters, one stream of bf16 normals drawn on `device`
    in chunks of `CHUNK` and taken in order by `fill`, each value scaled
    by its `_rule` in bf16.  The values therefore do not depend on the
    dtype the parameters are held in: a bf16 program and an fp32
    reference that fill the same modules in the same order hold the same
    numbers, and the reference may build and free one module at a time."""

    def __init__(self, seed: int, device, overrides: list):
        self.gen = torch.Generator(device=device).manual_seed(
            torch_seed(seed, 7))
        self.device = device
        self.overrides = overrides
        self.buf, self.pos = None, CHUNK

    @torch.no_grad()
    def fill(self, prefix: str, module) -> int:
        """Every parameter of `module`, in registration order; their
        names for the rules are `prefix.<name>`.  Returns the count."""
        count = 0
        for n, p in module.named_parameters():
            name = f"{prefix}.{n}"
            rule = _rule(name, p, self.overrides)
            size, done, flat = p.numel(), 0, p.view(-1)
            while done < size:
                if self.pos == CHUNK:
                    self.buf = torch.randn(CHUNK, generator=self.gen,
                                           device=self.device,
                                           dtype=torch.bfloat16)
                    self.pos = 0
                take = min(size - done, CHUNK - self.pos)
                draw = self.buf[self.pos:self.pos + take]
                if "value" in rule:
                    val = torch.tensor(rule["value"], dtype=torch.bfloat16,
                                       device=self.device)[done:done + take]
                elif "scale" in rule:
                    base = _rule(name, p, [])
                    val = (draw * base["std"] + base.get("mean", 0.0)) \
                        * rule["scale"]
                else:
                    val = draw * rule["std"] + rule.get("mean", 0.0)
                flat[done:done + take].copy_(val)
                done += take
                self.pos += take
            count += size
        return count


def fill_weights(modules: dict, seed: int, overrides: list, device) -> int:
    """Every parameter of `modules` ({prefix: module}, in that order) from
    one `WeightStream` of the seed."""
    stream = WeightStream(seed, device, overrides)
    return sum(stream.fill(k, m) for k, m in modules.items())


# --------------------------------------------------------------------------- #
# prompts and the stand-in tokenizer                                          #
# --------------------------------------------------------------------------- #

def prompts(path: str) -> list[str]:
    """The prompt list at `path` (relative to port_bench/)."""
    with open(HERE / path) as f:
        return [line.strip() for line in f if line.strip()]


def tokenizer(max_len: int, vocab: int):
    """A stand-in for the HF UMT5 tokenizer (the vocabulary is not in the
    repository): ids seeded by the text, padded to `max_len`, the mask as
    long as the text has words.  Copied from the port's `chip_smoke.py`."""
    def tokenize(text):
        r = np.random.default_rng(zlib.crc32(text.encode()))
        ids = r.integers(0, vocab, (1, max_len))
        mask = np.zeros((1, max_len), np.int64)
        mask[0, :min(len(text.split()), max_len)] = 1
        return ids, mask
    return tokenize


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64 on a's device (b the reference)."""
    a, b = a.double(), b.to(a.device).double()
    den = torch.linalg.vector_norm(b).item()
    return torch.linalg.vector_norm(a - b).item() / max(den, 1e-30)


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU, where the tests run)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def max_allocated(device) -> int:
    """The peak of allocated device memory since the last reset (0 on the
    CPU)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0
