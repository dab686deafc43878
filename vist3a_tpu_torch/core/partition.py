"""The trainable/frozen split as a predicate over parameter names.

Port of `vist3a_tpu/core/partition.py`.  The JAX package splits a nested
params tree by a predicate over key paths (`partition`) and reassembles it
(`combine`); here a model's parameters are (name, tensor) pairs as
`named_parameters()` gives them, and the two sides are flat dicts.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def partition(named: Iterable[tuple[str, torch.Tensor]],
              predicate: Callable[[str], bool]
              ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(taken, rest): the pairs whose name the predicate accepts, and the
    others."""
    taken, rest = {}, {}
    for name, tensor in named:
        (taken if predicate(name) else rest)[name] = tensor
    return taken, rest


def combine(a: dict[str, torch.Tensor],
            b: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Inverse of `partition`; raises if the two share a name."""
    overlap = a.keys() & b.keys()
    if overlap:
        raise ValueError(f"partitioned dicts overlap at {sorted(overlap)}")
    return {**a, **b}
