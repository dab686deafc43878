"""Stitching fine-tune: LoRA distillation of the stitched (chopped) AnySplat
toward the frozen full AnySplat, its teacher.

Port of `vist3a_tpu/train/stitching.py` for one device (the reference's
`model_stitching_training.py:196-366`):
  * trainables: the LoRA factors of every Linear / square Conv2d of the
    student, the stitch conv, the DINOv2 cls and register tokens, and the
    bias of every LoRA site (bias="lora_only");
  * AdamW (eps 1e-8, betas (0.9, 0.999), decoupled weight decay) under the
    optax warmup-cosine schedule from 0, the global gradient norm clipped
    to 1.0 as optax `clip_by_global_norm` clips it (g / ‖g‖ · 1 when
    ‖g‖ ≥ 1; `clip_grad_norm_` would divide by ‖g‖ + 1e-6);
  * per step a view count from {9, 13, 17, 21}, drawn identically on every
    host from (seed, step).

The student is `StitchedDecoder`'s structure on the meta device: it holds
no tensors.  Each step assembles its parameters — the teacher's own frozen
tensors (one copy, shared, as the JAX step derives its frozen tree from the
teacher's params), the trainable clones, and the LoRA-merged weights — and
runs it through `torch.func.functional_call` with remat (the unpadded trunk
layout, every flash call unmasked and differentiable).

The JAX package's `mask_structurally_unused` zeroes the AdamW updates of
trainables no path reads (the LoRA rows and biases of the chopped ViT
blocks, the mask token), because torch's AdamW skips a parameter whose
grad is None and optax does not.  The port's student holds no such
parameter, so here it is a check: every trainable must get a gradient.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from vist3a_tpu_torch.core.partition import combine, partition
from vist3a_tpu_torch.nn import encoder as encoder_mod
from vist3a_tpu_torch.stitch import lora as lora_mod
from vist3a_tpu_torch.stitch.chopped_anysplat import (StitchedConfig,
                                                      StitchedDecoder)
from vist3a_tpu_torch.train.losses import task_loss

VIEW_COUNTS = (9, 13, 17, 21)  # `model_stitching_training.py:101`


@dataclasses.dataclass(frozen=True)
class StitchTrainConfig:
    learning_rate: float = 1e-4          # `utils/argument.py:131`
    weight_decay: float = 1e-4           # `utils/argument.py:132`
    warmup_steps: int = 1000             # `utils/argument.py:135`
    total_steps: int = 30_000
    grad_clip: float = 1.0               # `model_stitching_training.py:167`
    lora_spec: str = "r64,a32,d0.0,f0"   # Readme.md stitching recipe
    betas: tuple = (0.9, 0.999)          # torch AdamW defaults

    @property
    def lora(self) -> lora_mod.LoraConfig:
        return lora_mod.parse_lora_mode(self.lora_spec)


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: dict      # {"lora": {site: {"a", "b"}}, "model": {name: P}}
    optimizer: torch.optim.AdamW


def lr_schedule(cfg: StitchTrainConfig, step: int) -> float:
    """optax `warmup_cosine_decay_schedule(0, lr, warmup, total, 0)`: linear
    from 0 over the warmup, then a cosine to 0 at `total_steps`."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    if warmup > 0 and step < warmup:
        count = min(max(step, 0), warmup)
        return (0.0 - peak) * (1 - count / warmup) + peak
    decay = cfg.total_steps - warmup
    count = min(step - warmup, decay)
    return peak * (0.5 * (1 + math.cos(math.pi * count / decay)))


def trainable_list(trainable: dict) -> list[nn.Parameter]:
    return ([f[k] for f in trainable["lora"].values() for k in ("a", "b")]
            + list(trainable["model"].values()))


def build_optimizer(trainable: dict,
                    cfg: StitchTrainConfig) -> torch.optim.AdamW:
    """AdamW over every trainable; `stitch_train_step` sets its lr each
    step from `lr_schedule`."""
    return torch.optim.AdamW(trainable_list(trainable), lr=0.0,
                             betas=cfg.betas, eps=1e-8,
                             weight_decay=cfg.weight_decay)


@functools.lru_cache(maxsize=4)
def student_skeleton(cfg: StitchedConfig) -> StitchedDecoder:
    """The student's modules on the meta device: its structure and names,
    no storage."""
    with torch.device("meta"):
        return StitchedDecoder(cfg)


def trainable_predicate(student: nn.Module, lora_cfg: lora_mod.LoraConfig):
    """Student parameter names that train besides the LoRA factors."""
    bias_pred = lora_mod.lora_bias_predicate(student, lora_cfg)
    special = {"encoder.vit.cls_token", "encoder.vit.register_tokens"}

    def pred(name: str) -> bool:
        return (name.startswith("stitch_conv.") or name in special
                or bias_pred(name))

    return pred


def split_params(teacher: encoder_mod.Encoder, stitch_conv: nn.Module | None,
                 scfg: StitchedConfig, lora_cfg: lora_mod.LoraConfig):
    """(taken, frozen) over the student's names, from the teacher's and the
    stitch conv's tensors (no copies); without a stitch conv, taken lacks
    it (the frozen side never holds it)."""
    student = student_skeleton(scfg)
    src = {f"encoder.{k}": v for k, v in teacher.named_parameters()}
    if stitch_conv is not None:
        src.update((f"stitch_conv.{k}", v)
                   for k, v in stitch_conv.named_parameters())
    return partition(((n, src[n]) for n, _ in student.named_parameters()
                      if n in src), trainable_predicate(student, lora_cfg))


def init_train_state(generator: torch.Generator,
                     teacher: encoder_mod.Encoder, stitch_conv: nn.Module,
                     scfg: StitchedConfig, cfg: StitchTrainConfig):
    """(state, frozen).  The trainable leaves are clones (the teacher keeps
    its own); the LoRA a factors are drawn with `generator`."""
    lcfg = cfg.lora
    taken, frozen = split_params(teacher, stitch_conv, scfg, lcfg)
    model = {n: nn.Parameter(t.detach().clone()) for n, t in taken.items()}
    lora = lora_mod.init_lora(student_skeleton(scfg), lcfg, generator)
    trainable = {"lora": lora, "model": model}
    return TrainState(0, trainable, build_optimizer(trainable, cfg)), frozen


def assemble_params(trainable: dict, frozen: dict,
                    lora_cfg: lora_mod.LoraConfig) -> dict:
    return lora_mod.merge_lora(combine(trainable["model"], frozen),
                               trainable["lora"], lora_cfg)


def mask_structurally_unused(trainable: dict) -> list[str]:
    """Trainables the backward left without a gradient (see the module
    docstring: the port's student reads them all, so this is empty)."""
    names = [f"lora.{s}.{k}" for s, f in trainable["lora"].items()
             for k in ("a", "b")] + [f"model.{n}" for n in trainable["model"]]
    return [n for n, p in zip(names, trainable_list(trainable))
            if p.grad is None]


def loss_fn(trainable: dict, frozen: dict, teacher_out, latent: torch.Tensor,
            images: torch.Tensor, scfg: StitchedConfig,
            lora_cfg: lora_mod.LoraConfig):
    """(total loss, the 15 terms) of the student with the assembled
    parameters against the teacher's outputs."""
    params = assemble_params(trainable, frozen, lora_cfg)
    student = functional_call(student_skeleton(scfg), params,
                              (latent, images, scfg), {"remat": True},
                              strict=True)
    losses = task_loss(student, teacher_out)
    return losses["total_loss"], losses


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t) for t in tensors]))


def stitch_train_step(state: TrainState, teacher: encoder_mod.Encoder,
                      latent: torch.Tensor, images: torch.Tensor,
                      images_teacher01: torch.Tensor, scfg: StitchedConfig,
                      train_cfg: StitchTrainConfig
                      ) -> dict[str, torch.Tensor]:
    """One distillation step, in place on `state`; returns the metrics
    (the 15 loss terms, the pre-clip `grad_norm`, the step's `lr`).

    latent:           (B, 16, T_vae, h, w) Wan latent of the clip.
    images:           (B, 3, S, H, W) in [−1, 1], the student's input.
    images_teacher01: (B, S, 3, H, W) in [0, 1], the teacher's."""
    lcfg = train_cfg.lora
    with torch.no_grad():
        teacher_out = encoder_mod.forward(teacher, images_teacher01,
                                          scfg.encoder, remat=True)
    # the frozen side is the teacher's tensors, derived as the JAX step does
    _, frozen = split_params(teacher, None, scfg, lcfg)
    params = trainable_list(state.trainable)
    for p in params:
        p.grad = None
    total, losses = loss_fn(state.trainable, frozen, teacher_out, latent,
                            images, scfg, lcfg)
    total.backward()
    unused = mask_structurally_unused(state.trainable)
    if unused:
        raise RuntimeError(f"trainables without a gradient: {unused[:8]}")
    grads = [p.grad for p in params]
    gnorm = global_norm(grads)
    # optax clip_by_global_norm: g unchanged below the limit, else g/‖g‖·c
    if gnorm >= train_cfg.grad_clip:
        torch._foreach_div_(grads, gnorm)
        torch._foreach_mul_(grads, train_cfg.grad_clip)
    lr = lr_schedule(train_cfg, state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return {**{k: v.detach() for k, v in losses.items()},
            "grad_norm": gnorm.detach(), "lr": torch.tensor(lr)}


def fold_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed mixed from (seed, *keys) — the counterpart of JAX's
    `fold_in`; numpy's `SeedSequence` does the mixing (a CPU generator's
    `manual_seed` keeps only 32 bits of what it is given)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


def sample_view_count(seed: int, step: int) -> int:
    """The step's view count, the same on every host: a CPU generator
    seeded from (seed, step), the counterpart of the JAX `fold_in(key,
    step)` draw (another generator, so other draws than JAX's)."""
    g = torch.Generator().manual_seed(fold_seed(seed, step))
    return VIEW_COUNTS[int(torch.randint(len(VIEW_COUNTS), (), generator=g))]
