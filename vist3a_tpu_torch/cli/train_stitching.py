"""Entry point: stitching distillation training.

Port of `vist3a_tpu/cli/train_stitching.py` (the reference's
`model_stitching_training.py`): per step a view count from
{9, 13, 17, 21} (drawn from (seed, step), the same on every host), the
batch sliced to it, a frozen Wan VAE encode of the clip and a posterior
sample, then `stitch_train_step`.  `run` takes any iterable of batches
{"vae_image_tensor", "feedforward_image_tensor"}, each (B, 3, T, H, W) in
[−1, 1], numpy or torch, and the sampler whose `set_epoch` it calls at the
start of every epoch.  With `save_path` it saves after every epoch; with
`resume_path` (a folder a run saved to) it goes on after the saved epoch,
the step, the trainables and the AdamW state restored (`io/checkpoints.py`,
as `vist3a_tpu/cli/train_stitching.py:57-98` does).  Every draw of a step
comes from (seed, step), so a resumed run takes the steps an unbroken one
takes.

`main` is the command line (`:102-158`): the AnySplat encoder and the Wan
VAE encoder from the weights root, the stitch conv from
`--initialization_weight_path` ({weight, bias}) or drawn from
`--global_seed`, the DL3DV / ScanNet loader with colour augmentation, the
cosine schedule over `num_epochs · len(loader)` steps and the metric
stream (`core/wandb_log.py`):

    VIST3A_WEIGHTS=ROOT python -m vist3a_tpu_torch.cli.train_stitching \\
        --dataset dl3dv:/data/dl3dv --dataset scannet:/data/scannet \\
        --stitching_layer_location enc_blocks_16 \\
        --initialization_weight_path init.pth \\
        --lora_config r64,a32,d0.0,f0 --batch_size 1 --num_epochs 30 \\
        --save_path out

`--weights_root` is not a flag of this parser (as in the JAX package); set
$VIST3A_WEIGHTS or the attribute.  Data-parallel (DDP, the reference's
torchrun launch, `model_stitching_training.py:286-289`), one process per
GPU:

    VIST3A_WEIGHTS=ROOT torchrun --nproc_per_node 8 \
        -m vist3a_tpu_torch.cli.train_stitching --mesh_data 8 ...

`main` calls `core/distributed.py::setup_dist` (NCCL from torchrun's
environment) and builds the `(data, model)` mesh of the flags; each rank
loads its share of the loader by its data index, the posterior noise is
drawn for the global batch and sliced to the rank's rows, the gradients
are averaged before the clip (`train/stitching.py`), the main process
alone saves and logs.
"""

from __future__ import annotations

import torch
from torch import nn

from vist3a_tpu_torch.cli.arguments import stitching_training_argument
from vist3a_tpu_torch.core import distributed
from vist3a_tpu_torch.core import mesh as mesh_mod
from vist3a_tpu_torch.io import checkpoints as ckpt
from vist3a_tpu_torch.nn import wan_vae
from vist3a_tpu_torch.stitch.chopped_anysplat import StitchedConfig
from vist3a_tpu_torch.train import stitching as st


def encode_context(vae: wan_vae.WanVAEEncoder, vae_images_pm1: torch.Tensor,
                   generator: torch.Generator, mesh=None) -> torch.Tensor:
    """Frozen VAE encode of the sliced clip and a posterior sample
    (`models/stitched_model.py:133`), without grad.  On a mesh the noise
    is drawn for the global batch and this rank's rows kept, so N data
    ranks draw what one rank draws for their concatenated batch."""
    mu, logvar = wan_vae.encode(vae, vae_images_pm1)
    eps = mesh_mod.randn_rows(mu.shape, generator, mesh, device=mu.device,
                              dtype=mu.dtype)
    return wan_vae.sample_posterior(mu, logvar, generator, eps=eps)


def run(params: dict[str, nn.Module], scfg: StitchedConfig, loader,
        sampler=None, *, train_cfg: st.StitchTrainConfig, num_epochs: int,
        seed: int = 23, save_path=None, resume_path=None,
        log_every: int = 10, on_metrics=None, mesh=None):
    """The training loop.  params: {"encoder": the full teacher `Encoder`,
    "stitch_conv": the initial stitch conv, "vae": a `WanVAEEncoder`}, all
    on one device, which the batches are moved to.  `sampler.set_epoch(epoch)`
    is called at the start of every epoch (the loader's sampler; None for
    an in-memory list).  Returns (state, history), history the metrics of
    every `log_every`-th step of this call as floats.

    With `mesh` (`core/mesh.py`) the loop runs data-parallel: the loader
    yields this rank's rows of the global batch, every rank keeps a full
    replica of the trainables, the main process saves (the others wait at
    a barrier) and every rank loads on resume."""
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
        if sampler is not None:
            sampler.set_epoch(epoch)
        for batch in loader:
            gstep = state.step
            n_views = st.sample_view_count(seed, gstep)
            vae_images = torch.as_tensor(
                batch["vae_image_tensor"][:, :, :n_views]).to(device)
            ff_images = torch.as_tensor(
                batch["feedforward_image_tensor"][:, :, :n_views]).to(device)
            noise = torch.Generator(device=device).manual_seed(
                st.fold_seed(seed, 2 * gstep + 1))
            latent = encode_context(vae, vae_images, noise, mesh)
            teacher01 = ((ff_images + 1.0) * 0.5).transpose(1, 2)
            metrics = st.stitch_train_step(state, teacher, latent, ff_images,
                                           teacher01, scfg, train_cfg, mesh)
            if gstep % log_every == 0:
                history.append({"epoch": epoch, "step": gstep,
                                "views": n_views,
                                **{k: float(v) for k, v in metrics.items()}})
                if on_metrics:
                    on_metrics(history[-1])
        if save_path is not None:
            # the writer: the main process of a mesh's group (a run
            # without groups is one process)
            if not mesh_mod.active(mesh) or distributed.is_main_process():
                ckpt.save_stitching_checkpoint(save_path, epoch, state)
            if mesh_mod.active(mesh):
                distributed.barrier()
    return state, history


def main(args, *, device: torch.device | str = "cuda"):
    """The command line: the process group of a launcher's environment
    (`setup_dist`; none without one) and the mesh of the flags, every
    module from the weights root and the files the flags name, then `run`
    over the datasets.  Returns `run`'s (state, history).  Nothing of the
    run outlives the call but what it returns: the modules are locals of
    `_train`, and a group this call started is destroyed on the way out."""
    from vist3a_tpu_torch.core.wandb_log import make_run

    started = distributed.setup_dist(device)
    try:
        # each process loads its per-device `--batch_size`
        # (`mesh_mod.local_batch_size`)
        mesh = mesh_mod.mesh_from_args(args)
        # the rank-0 metric stream (`model_stitching_training.py:173-193`),
        # started before any module is loaded: wandb's error reporting
        # keeps a failed init's exception, and with it every frame up the
        # stack, this one included, after `main` returns; the modules are
        # locals of `_train`, which is not on that stack
        logger = make_run(args.wandb_logging,
                          project=args.wandb_project_name,
                          run_name=args.exp_name, config=vars(args),
                          out_dir=args.save_path)
        try:
            return _train(args, mesh, logger, device)
        finally:
            logger.finish()
    finally:
        if started:
            distributed.cleanup()


def _train(args, mesh: mesh_mod.Mesh, logger, device):
    from vist3a_tpu_torch.cli import model_loading as ml
    from vist3a_tpu_torch.data.loader import create_stitching_dataloader
    from vist3a_tpu_torch.io.load_weights import load_torch_state_dict
    from vist3a_tpu_torch.nn.layers import build_random
    from vist3a_tpu_torch.stitch.chopped_anysplat import init_stitch_conv

    root = ml.weights_root(args)
    scfg = ml.stitched_config(args)
    encoder = ml.load_anysplat_encoder(root, scfg.encoder, device=device)
    vae = ml.load_wan_vae(root, ml.WanVAEConfig(), halves=("encoder",),
                          device=device)["encoder"]
    if args.initialization_weight_path:
        init_sd = load_torch_state_dict(args.initialization_weight_path)
        stitch_conv = init_stitch_conv(scfg).to(device)
        stitch_conv.load_state_dict(
            {"weight": init_sd["weight"], "bias": init_sd["bias"]},
            strict=True)
    else:
        gen = torch.Generator(device=device).manual_seed(args.global_seed)
        stitch_conv = build_random(lambda: init_stitch_conv(scfg), gen,
                                   device, torch.float32)

    loader, sampler = create_stitching_dataloader(
        [(n, str(p)) for n, p in args.dataset], args, augmentation=True,
        num_replicas=mesh_mod.data_size(mesh),
        rank=mesh_mod.data_index(mesh))
    train_cfg = st.StitchTrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps,
        total_steps=args.num_epochs * len(loader),
        lora_spec=args.lora_config)

    def on_metrics(m):
        if distributed.is_main_process():
            print(m)
        logger.log(m, step=m.get("step"))

    return run({"encoder": encoder, "stitch_conv": stitch_conv, "vae": vae},
               scfg, loader, sampler, train_cfg=train_cfg,
               num_epochs=args.num_epochs, seed=args.global_seed,
               save_path=args.save_path,
               resume_path=args.resume_checkpoint_path,
               on_metrics=on_metrics, mesh=mesh)


if __name__ == "__main__":
    main(stitching_training_argument().parse_args())
