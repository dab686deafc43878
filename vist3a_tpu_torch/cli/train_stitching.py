"""Stitching distillation training: the loop.

Port of `vist3a_tpu/cli/train_stitching.py::run` for one device: per step
a view count from {9, 13, 17, 21} (drawn from (seed, step), the same on
every host), the batch sliced to it, a frozen Wan VAE encode of the clip
and a posterior sample, then `stitch_train_step`.  `run` takes any iterable
of batches {"vae_image_tensor", "feedforward_image_tensor"}, each (B, 3, T,
H, W) in [−1, 1].  With `save_path` it saves after every epoch; with
`resume_path` (a folder a run saved to) it goes on after the saved epoch,
the step, the trainables and the AdamW state restored (`io/checkpoints.py`,
as `vist3a_tpu/cli/train_stitching.py:57-98` does).  Every draw of a step
comes from (seed, step), so a resumed run takes the steps an unbroken one
takes.

Not here yet: the DL3DV / ScanNet loaders and the metric stream (ROADMAP
Queue 1, item 14) and the data-parallel mesh (DDP, item 21).
"""

from __future__ import annotations

import torch
from torch import nn

from vist3a_tpu_torch.io import checkpoints as ckpt
from vist3a_tpu_torch.nn import wan_vae
from vist3a_tpu_torch.stitch.chopped_anysplat import StitchedConfig
from vist3a_tpu_torch.train import stitching as st


def encode_context(vae: wan_vae.WanVAEEncoder, vae_images_pm1: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """Frozen VAE encode of the sliced clip and a posterior sample
    (`models/stitched_model.py:133`), without grad."""
    mu, logvar = wan_vae.encode(vae, vae_images_pm1)
    return wan_vae.sample_posterior(mu, logvar, generator)


def run(params: dict[str, nn.Module], scfg: StitchedConfig, loader, *,
        train_cfg: st.StitchTrainConfig, num_epochs: int, seed: int = 23,
        save_path=None, resume_path=None, log_every: int = 10,
        on_metrics=None):
    """The training loop.  params: {"encoder": the full teacher `Encoder`,
    "stitch_conv": the initial stitch conv, "vae": a `WanVAEEncoder`}, all
    on one device, which the batches are moved to.  Returns (state,
    history), history the metrics of every `log_every`-th step of this
    call as floats."""
    teacher, vae = params["encoder"], params["vae"]
    device = next(teacher.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    state, _ = st.init_train_state(gen, teacher, params["stitch_conv"], scfg,
                                   train_cfg)
    epoch_start = 0
    if resume_path is not None:
        epoch_start, state = ckpt.load_stitching_checkpoint(resume_path,
                                                            state)
    history = []
    for epoch in range(epoch_start, num_epochs):
        for batch in loader:
            gstep = state.step
            n_views = st.sample_view_count(seed, gstep)
            vae_images = batch["vae_image_tensor"][:, :, :n_views].to(device)
            ff_images = batch["feedforward_image_tensor"][:, :, :n_views] \
                .to(device)
            noise = torch.Generator(device=device).manual_seed(
                st.fold_seed(seed, 2 * gstep + 1))
            latent = encode_context(vae, vae_images, noise)
            teacher01 = ((ff_images + 1.0) * 0.5).transpose(1, 2)
            metrics = st.stitch_train_step(state, teacher, latent, ff_images,
                                           teacher01, scfg, train_cfg)
            if gstep % log_every == 0:
                history.append({"epoch": epoch, "step": gstep,
                                "views": n_views,
                                **{k: float(v) for k, v in metrics.items()}})
                if on_metrics:
                    on_metrics(history[-1])
        if save_path is not None:
            ckpt.save_stitching_checkpoint(save_path, epoch, state)
    return state, history
