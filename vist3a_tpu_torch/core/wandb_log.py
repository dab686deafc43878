"""wandb-compatible run logger with a JSONL fallback.

Port of `vist3a_tpu/core/wandb_log.py`.  The reference logs scalar metric
dicts and image lists to wandb on the main process only: the 16 stitching
terms, lr and grad_norm (`model_stitching_training.py:173-193`), the VDM
losses and the every-10-step decoded-vs-rendered grids
(`train_vdm.py:651-688`).  The CLIs call `make_run(...)`, which returns a
`RunLogger`:

  * with `--wandb_logging` and an importable `wandb` → a wandb run
    (`wandb.init(project=..., name=..., config=...)`), scalars through
    `run.log(d, step=...)`, images through `wandb.Image`;
  * otherwise → a JSONL writer (`<out_dir>/<run_name>.metrics.jsonl`, one
    record per `log` call), so the terms are always kept.  The VDM image
    grids go to PNG files either way.

Only rank 0 emits (the reference's `accelerator.is_main_process`): the rank
of an initialised `torch.distributed`, else 0; other ranks get a no-op
logger.  `wandb` is imported only inside `make_run`.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np


class RunLogger:
    """No-op base (used as-is on non-zero ranks)."""

    enabled = False

    def log(self, metrics: dict, step: int | None = None) -> None:
        pass

    def log_images(self, name: str, images, step: int | None = None) -> None:
        """images: iterable of (H, W, 3) float arrays in [0, 1]."""

    def finish(self) -> None:
        pass


class _JsonlLogger(RunLogger):
    enabled = True

    def __init__(self, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, metrics, step=None):
        rec = dict(metrics)
        if step is not None:
            rec.setdefault("step", int(step))
        self._f.write(json.dumps(
            {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
             for k, v in rec.items()}) + "\n")

    def finish(self):
        self._f.close()


class _WandbLogger(RunLogger):
    enabled = True

    def __init__(self, wandb, project, run_name, config):
        self._wandb = wandb
        self._run = wandb.init(project=project, name=run_name,
                               config=config or {})

    def log(self, metrics, step=None):
        self._run.log(dict(metrics), step=step)

    def log_images(self, name, images, step=None):
        imgs = [self._wandb.Image(
            np.clip(np.asarray(im, np.float32), 0.0, 1.0), caption=str(i))
            for i, im in enumerate(images)]
        self._run.log({name: imgs}, step=step)

    def finish(self):
        self._run.finish()


def process_index() -> int:
    """This process's rank in an initialised `torch.distributed`, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def make_run(enabled: bool, *, project: str = "wan+anysplat",
             run_name: str | None = None, config: dict | None = None,
             out_dir=None) -> RunLogger:
    """Build the rank-0 logger.  `enabled=False` → pure no-op (the CLIs call
    unconditionally); without `wandb`, or when its run does not start, a
    JSONL stream, so the flag always leaves a durable metric stream."""
    if not enabled or process_index() != 0:
        return RunLogger()
    try:
        import wandb
    except ImportError:
        wandb = None
    if wandb is not None:
        try:
            return _WandbLogger(wandb, project, run_name, config)
        except Exception as e:  # noqa: BLE001 — the JSONL stream takes over
            warnings.warn(f"wandb.init failed ({e!r}); the metrics go to "
                          "a JSONL file")
    name = run_name or "run"
    base = Path(out_dir) if out_dir else Path(".")
    return _JsonlLogger(base / f"{name}.metrics.jsonl")
