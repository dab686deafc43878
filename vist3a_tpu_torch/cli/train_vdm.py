"""Entry point: reward-aligned VDM fine-tuning.

Port of `vist3a_tpu/cli/train_vdm.py` (the reference's
`train_vdm.py:284-691`).  `run` is the loop: per step one text batch (its
first prompt, camera-augmented, is the rollout prompt) and one video batch
(the SFT clip and its captions), the prompts embedded by `embed_text`, the
scorer text features of the prompt from `reward_text_fn`, then
`vdm_train_step`.  The loaders are any iterables: `text_loader` yields
{"prompt": [str]}, `video_loader` {"image_tensor": (B, 3, T, H, W) in
[−1, 1] (numpy or torch), "caption": [str]}; the video loader restarts
when it runs out, and the text loader is walked until `num_steps`.  A
loader with a `sampler` has `set_epoch` called at every pass, with the
epoch the step count gives.

With `save_path` the loop saves a `checkpoint-N` folder every `save_freq`
steps (`io/checkpoints.py`, `train_vdm.py:439-496`), the decoded-vs-rendered
image grid of every 10th reward step (`images/step_<N>.png`, :665-688) and,
at the end, the metrics of every step (`history.jsonl`); `resume_path`
(such a folder, or a folder holding them: the latest is taken) restores the
step, the LoRA factors, the AdamW state, the EMA shadow and the position of
the host-side draws (the prompt augmentation's generator), and both loaders
skip the batches the saved run consumed (:465-496), so the run goes on
exactly as an unbroken one.  Resuming mid-stream needs sized loaders.

`build_reward_fns` loads the two scorers (PickScore in the HF layout with
its `vocab.json` + `merges.txt`, DFN5B in open_clip's) and returns the
reward loss over their vision towers and the per-prompt text features of
their text towers, cached.  `main` is the command line:

    VIST3A_WEIGHTS=ROOT python -m vist3a_tpu_torch.cli.train_vdm \\
        --checkpoint_path ROOT/anysplat_stitched.pth \\
        --stitching_layer_location enc_blocks_16 \\
        --lora_config r64,a32,d0.0,f0 --enable_rl \\
        --dataset dl3dv:/data/dl3dv --text_dataset_path prompts.txt \\
        --save_path out --save_freq 100

(`weights_root` and `text_annotation_path`, the DL3DV caption JSON, are
no flags of this parser, as in the JAX package: attributes of `args`, else
$VIST3A_WEIGHTS and `data/dl3dv_text_label_980P.json`.)  The UMT5
tokenizer is `transformers`' from `{root}/umt5` unless `main` is handed a
`tokenize` callable.  The DiT and UMT5 run in bf16 (the reference's
autocast; the JAX main keeps fp32 parameters), the VAE in fp32 weights
with bf16 activations, the scorers in fp32.

Over several GPUs (the reference's accelerate FSDP2 launch,
`train_vdm.py:296-310`), one process each:

    VIST3A_WEIGHTS=ROOT torchrun --nproc_per_node 8 \
        -m vist3a_tpu_torch.cli.train_vdm --mesh_data 4 --mesh_model 2 \
        --dit_sharding tp_fsdp --model_id Wan-AI/Wan2.1-T2V-14B-Diffusers ...

`--dit_sharding` places the DiT (`core/mesh.py::place_dit`: fsdp, tp,
tp_fsdp, replicated); the VAE, the stitched decoder and the scorers stay
replicated, as in the JAX package (`vist3a_tpu/cli/train_vdm.py:48-58`).
The loaders are split by the rank's data index, the main process alone
saves, writes the image grids and `history.jsonl`, and logs.
"""

from __future__ import annotations

import functools
import itertools
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from vist3a_tpu_torch.cli.arguments import (training_vdm_argument,
                                            validate_vdm_args)
from vist3a_tpu_torch.core import distributed
from vist3a_tpu_torch.core import mesh as mesh_mod
from vist3a_tpu_torch.io import checkpoints as ckpt
from vist3a_tpu_torch.nn import wan_dit, wan_vae
from vist3a_tpu_torch.stitch import chopped_anysplat as ca
from vist3a_tpu_torch.train import ema as ema_mod
from vist3a_tpu_torch.train import vdm


def save(save_path, state: vdm.VDMTrainState,
         rng: np.random.Generator) -> str:
    """`checkpoint-{state.step}` of the run's state and draws' position."""
    lora = vdm.flat_lora(state.lora)
    return ckpt.save_vdm_checkpoint(
        save_path, state.step, lora=lora,
        lora_ema=ema_mod.ema_params_like(state.ema, lora),
        opt_state=state.optimizer.state_dict(), ema_shadow=state.ema,
        meta={"step": state.step, "rng": rng.bit_generator.state})


def restore(resume_path, state: vdm.VDMTrainState,
            rng: np.random.Generator) -> str:
    """Load a `checkpoint-N` folder (or the latest one inside
    `resume_path`) into `state` and `rng`, in place; returns its path."""
    path = resume_path
    if not (Path(path) / "meta.json").exists():
        path = ckpt.latest_checkpoint(resume_path)
        if path is None:
            raise FileNotFoundError(f"no checkpoint-N under {resume_path}")
    lora, _, opt_state, ema_shadow, meta = ckpt.load_vdm_checkpoint(path)
    own = vdm.flat_lora(state.lora)
    if own.keys() != lora.keys() or state.ema.keys() != ema_shadow.keys():
        raise KeyError(f"{path} holds other LoRA sites than the run's")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(lora[k])
            state.ema[k].copy_(ema_shadow[k])
    state.optimizer.load_state_dict(opt_state)
    state.step = int(meta["step"])
    rng.bit_generator.state = meta["rng"]
    return str(path)


def _position(loader, step: int) -> tuple[int, int]:
    """(pass, batches of that pass) that `step` steps consumed of
    `loader`."""
    if not step:
        return 0, 0
    try:
        return divmod(step, len(loader))
    except TypeError:
        raise ValueError("resuming mid-stream needs loaders with a length "
                         "(the batches consumed cannot be skipped)") from None


def _set_epoch(loader, epoch: int) -> None:
    sampler = getattr(loader, "sampler", None)
    if sampler is not None:
        sampler.set_epoch(epoch)


def _batches(loader, skip: int):
    """An iterator over `loader` without its first `skip` batches, which
    a `BatchLoader` drops unloaded (`skip_first_batches`)."""
    if skip and hasattr(loader, "skip_first_batches"):
        loader.skip_first_batches(skip)
        skip = 0
    return itertools.islice(iter(loader), skip, None)


def run(state: vdm.VDMTrainState, dit: wan_dit.WanDiT,
        vae_encoder: wan_vae.WanVAEEncoder,
        vae_decoder: wan_vae.WanVAEDecoder, stitched: ca.StitchedDecoder, *,
        text_loader, video_loader, embed_text: Callable,
        reward_loss_fn: Callable | None, scfg: ca.StitchedConfig,
        cfg: vdm.VDMTrainConfig, num_steps: int, save_path=None,
        save_freq: int = 100, resume_path=None, seed: int = 23,
        latent_shape=(1, 16, 4, 64, 64), render_size: int = 448,
        on_metrics=None, uncond_embeds: torch.Tensor | None = None,
        reward_text_fn: Callable | None = None, logger=None, mesh=None):
    """The VDM loop until `state.step == num_steps`.  embed_text(list[str])
    → (B, L, text_dim) on the models' device; reward_text_fn(prompt) →
    (pick_text, pe_text); logger: a `core/wandb_log.py` RunLogger.
    Returns (state, history), history the metrics of every step of this
    call (floats, the draws, the prompt).  `mesh` (`core/mesh.py`): the
    video batches are this rank's rows, the DiT as `place_dit` left it;
    the main process writes, the others wait at a barrier."""
    device = dit.patch_embedding.weight.device
    # the writer: the main process of a mesh's group; a run without
    # groups is one process, and writes
    main = not mesh_mod.active(mesh) or distributed.is_main_process()
    rng = np.random.default_rng(seed)
    if resume_path is not None:
        restore(resume_path, state, rng)
    history = []
    text_epoch, skip_text = _position(text_loader, state.step)
    video_epoch, skip_video = _position(video_loader, state.step)
    _set_epoch(text_loader, text_epoch)
    _set_epoch(video_loader, video_epoch)
    texts = _batches(text_loader, skip_text)
    video_iter = _batches(video_loader, skip_video)
    while state.step < num_steps:
        for text_batch in texts:
            if state.step >= num_steps:
                break
            try:
                video_batch = next(video_iter)
            except StopIteration:
                video_epoch += 1
                _set_epoch(video_loader, video_epoch)
                video_iter = iter(video_loader)
                video_batch = next(video_iter)
            prompt = text_batch["prompt"][0]
            sft_text = embed_text(list(video_batch["caption"]))
            rl_prompt = vdm.augment_camera_prompt(rng, prompt) \
                if cfg.enable_rl else prompt
            rl_cond = embed_text([rl_prompt])
            rl_uncond = (uncond_embeds.to(device) if uncond_embeds is not None
                         else torch.zeros_like(rl_cond))
            reward_text = (reward_text_fn(prompt)
                           if cfg.enable_rl and reward_text_fn else None)
            # every 10th step's decoded-vs-rendered grid (`train_vdm.py:
            # 665-688`); the grid shows this step's rollout
            img_step = state.step
            want_images = (cfg.enable_rl and reward_loss_fn is not None
                           and save_path is not None and img_step % 10 == 0)
            metrics = vdm.vdm_train_step(
                state, dit, vae_encoder, vae_decoder, stitched,
                video=torch.as_tensor(video_batch["image_tensor"]).to(device),
                sft_text=sft_text, rl_cond=rl_cond, rl_uncond=rl_uncond,
                reward_loss_fn=reward_loss_fn, seed=seed, scfg=scfg, cfg=cfg,
                latent_shape=latent_shape, render_size=render_size,
                reward_text=reward_text, return_images=want_images,
                mesh=mesh)
            imgs = metrics.pop("images", None)
            m = {k: v if isinstance(v, (bool, int, float, list))
                 else float(v) for k, v in metrics.items()}
            history.append({"step": state.step, "prompt": prompt,
                            "rl_prompt": rl_prompt, **m})
            if on_metrics:
                on_metrics(history[-1])
            if logger is not None:
                logger.log({"prompt": prompt, **m}, step=state.step)
            if imgs is not None and main:
                decoded, rendered = (t.float().cpu().numpy() for t in imgs)
                _save_image_grid(Path(save_path) / "images"
                                 / f"step_{img_step:06d}.png",
                                 (decoded, rendered))
                if logger is not None:
                    # the decoded frame, then the renders, one image each
                    logger.log_images("images",
                                      list(decoded) + list(rendered),
                                      step=img_step)
            if save_path is not None and state.step % save_freq == 0:
                if main:
                    save(save_path, state, rng)
                if mesh_mod.active(mesh):
                    distributed.barrier()
        text_epoch += 1                       # `train_vdm.py:689-691`
        _set_epoch(text_loader, text_epoch)
        texts = iter(text_loader)
    if save_path is not None and main:
        Path(save_path).mkdir(parents=True, exist_ok=True)
        (Path(save_path) / "history.jsonl").write_text(
            "\n".join(json.dumps(h) for h in history))
    if save_path is not None and mesh_mod.active(mesh):
        distributed.barrier()
    return state, history


def _save_image_grid(path: Path, imgs, cols: int = 7) -> None:
    """(decoded (1, H, W, 3), rendered (V, H, W, 3)) in [0, 1] → one PNG
    grid, `cols` tiles a row (the file form of the reference's wandb image
    log), written by `imageio` where it imports, else by OpenCV."""
    decoded, rendered = imgs
    tiles = np.concatenate([np.asarray(decoded, np.float32),
                            np.asarray(rendered, np.float32)], axis=0)
    tiles = (np.clip(tiles, 0.0, 1.0) * 255.0).astype(np.uint8)
    n, h, w, c = tiles.shape
    cols = min(cols, n)
    rows = -(-n // cols)
    pad = rows * cols - n
    if pad:
        tiles = np.concatenate(
            [tiles, np.zeros((pad, h, w, c), np.uint8)], axis=0)
    grid = tiles.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4) \
        .reshape(rows * h, cols * w, c)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        imageio.imwrite(str(path), grid)
        return
    import cv2

    if not cv2.imwrite(str(path), np.ascontiguousarray(grid[:, :, ::-1])):
        raise OSError(f"cv2 could not write {path}")


def build_reward_fns(root, *, pick_dir: str = "pickscore",
                     pe_dir: str = "dfn5b", rcfg=None, text_cfg=None,
                     device: torch.device | str = "cuda"):
    """The reward scorers from `{root}/{pick_dir}` (PickScore, HF CLIP-H,
    with the tokenizer files) and `{root}/{pe_dir}` (DFN5B, open_clip
    ViT-H-378) (`utils/reward.py:117-193`, `train_vdm.py:566-637`): each
    file checked against its manifest when the configs are the deployed
    ones, both towers of each imported in fp32 on `device`, `logit_scale`
    the exp of the file's.  Returns (reward_loss_fn, reward_text_fn),
    reward_text_fn(prompt) → (pick_text, pe_text), (1, D) L2-normalised
    features computed without grad and cached per prompt."""
    from vist3a_tpu_torch.io import load_weights, manifests
    from vist3a_tpu_torch.io.weight_import import build_module
    from vist3a_tpu_torch.nn import clip as clip_mod
    from vist3a_tpu_torch.train import reward as reward_mod

    root = Path(root)
    pick_sd = load_weights.load_sharded_safetensors(root / pick_dir)
    pe_sd = load_weights.load_sharded_safetensors(root / pe_dir)
    rcfg = rcfg or reward_mod.RewardConfig()
    if rcfg.pick_cfg == reward_mod.RewardConfig().pick_cfg:
        # the manifests describe the deployed towers; tiny configs skip
        manifests.validate_state_dict(pick_sd, "pickscore")
        manifests.validate_state_dict(pe_sd, "dfn5b")
    tcfg = text_cfg or clip_mod.CLIP_H_TEXT

    def tower(cls, cfg, state):
        return build_module(lambda: cls(cfg), state, device=device)
    pick = tower(clip_mod.CLIPVision, rcfg.pick_cfg,
                 clip_mod.import_hf_clip_vision(pick_sd,
                                                rcfg.pick_cfg.num_layers))
    pe = tower(clip_mod.CLIPVision, rcfg.pe_cfg,
               clip_mod.import_open_clip_vision(pe_sd,
                                                rcfg.pe_cfg.num_layers))
    pick_text = tower(clip_mod.CLIPText, tcfg,
                      clip_mod.import_hf_clip_text(pick_sd, tcfg.num_layers))
    pe_text = tower(clip_mod.CLIPText, tcfg,
                    clip_mod.import_open_clip_text(pe_sd, tcfg.num_layers))
    # `pick_model.logit_scale.exp()` (`utils/reward.py:159-161`)
    logit_scale = float(np.exp(pick_sd["logit_scale"].float().numpy()))
    tokenizer = _clip_tokenizer_from_dir(root / pick_dir)
    del pick_sd, pe_sd
    loss_fn = reward_mod.make_loss_fn(pick, pe, logit_scale=logit_scale,
                                      cfg=rcfg)

    @functools.lru_cache(maxsize=256)
    @torch.no_grad()
    def reward_text_fn(prompt: str):
        # HF CLIP pads with EOT ("eos"), open_clip with zeros: argmax-EOS
        # pooling is right under both
        feats = []
        for model, pad in ((pick_text, "eos"), (pe_text, "zero")):
            ids = torch.from_numpy(
                tokenizer([prompt], tcfg.context_length, pad=pad))
            feats.append(clip_mod.text_features(model, ids))
        return tuple(feats)

    return loss_fn, reward_text_fn


def _clip_tokenizer_from_dir(model_dir):
    """vocab.json + merges.txt (HF layout) or the openai
    bpe_simple_vocab_16e6.txt(.gz) merges file (open_clip layout)."""
    from vist3a_tpu_torch.data.clip_tokenizer import CLIPTokenizer

    model_dir = Path(model_dir)
    vocab, merges = model_dir / "vocab.json", model_dir / "merges.txt"
    if vocab.exists() and merges.exists():
        return CLIPTokenizer.from_files(str(vocab), str(merges))
    for name in ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt"):
        if (model_dir / name).exists():
            return CLIPTokenizer.from_openai_merges(str(model_dir / name))
    raise FileNotFoundError(
        f"no CLIP tokenizer files (vocab.json+merges.txt or openai bpe "
        f"merges) under {model_dir}")


def main(args, tokenize: Callable | None = None, *,
         device: torch.device | str = "cuda"):
    """The command line: the process group of a launcher's environment
    (`setup_dist`; none without one) and the mesh of the flags, the
    stitched decoder, the Wan VAE, UMT5, the DiT (placed by
    `--dit_sharding`) and (with `--enable_rl`) the scorers from the
    weights root and the checkpoint, the DL3DV clip loader and the prompt
    loader, then `run` for `num_epochs · len(video loader)` steps.
    tokenize(text) → (ids (1, 226), mask (1, 226)); None loads
    `transformers`' UMT5 tokenizer from `{root}/umt5`.  Returns `run`'s
    (state, history); the modules are locals of `_train`, and a group this
    call started is destroyed on the way out."""
    from vist3a_tpu_torch.core.wandb_log import make_run

    validate_vdm_args(training_vdm_argument(), args)
    started = distributed.setup_dist(device)
    try:
        # each process loads its per-device `--batch_size`
        # (`mesh_mod.local_batch_size`)
        mesh = mesh_mod.mesh_from_args(args)
        # the rank-0 metric and image stream (`train_vdm.py:651-688`; the
        # PNG grids are written either way), started before any module
        # is loaded (a failed wandb start keeps this frame: see
        # `cli/train_stitching.py::main`)
        logger = make_run(args.wandb_logging,
                          project=args.wandb_project_name,
                          run_name=args.exp_name, config=vars(args),
                          out_dir=args.save_path)
        try:
            return _train(args, tokenize, mesh, logger, device)
        finally:
            logger.finish()
    finally:
        if started:
            distributed.cleanup()


def _train(args, tokenize, mesh: mesh_mod.Mesh, logger, device):
    from vist3a_tpu_torch.cli.inference_t23d import (hf_tokenizer,
                                                     load_generator)
    from vist3a_tpu_torch.cli import model_loading
    from vist3a_tpu_torch.cli.model_loading import (load_stitched_model,
                                                    load_wan_vae,
                                                    weights_root)
    from vist3a_tpu_torch.data.loader import create_vdm_tuning_dataloader
    from vist3a_tpu_torch.nn import umt5 as umt5_mod

    root = weights_root(args)
    modules, scfg = load_stitched_model(args, device=device)
    stitched = modules["stitched"]
    del modules
    # the VAE in fp32 weights (bf16 activations inside the step), both
    # halves: the SFT clip is encoded, the rollout decoded
    vae = load_wan_vae(root, model_loading.WanVAEConfig(), device=device)
    gen_models = load_generator(root, args.model_id, device=device)
    umt5, dit = gen_models["umt5"], gen_models["dit"]
    del gen_models
    if tokenize is None:
        tokenize = hf_tokenizer(root / "umt5")

    def embed_text(prompts):
        ids, mask = zip(*(tokenize(p) for p in prompts))
        return umt5_mod.encode(
            umt5, torch.as_tensor(np.concatenate(ids), device=device),
            torch.as_tensor(np.concatenate(mask), device=device))

    reward_loss_fn = reward_text_fn = None
    if args.enable_rl:
        reward_loss_fn, reward_text_fn = build_reward_fns(root,
                                                          device=device)
    datasets = [(n, str(p)) for n, p in args.dataset]
    if args.text_dataset_path:
        datasets.append(("text", args.text_dataset_path))
    text_loader, _, video_loader, _ = create_vdm_tuning_dataloader(
        datasets, args, num_replicas=mesh_mod.data_size(mesh),
        rank=mesh_mod.data_index(mesh))

    cfg = vdm.VDMTrainConfig(learning_rate=args.learning_rate,
                             weight_decay=args.weight_decay,
                             enable_rl=args.enable_rl)
    # the state takes the sites' full shapes, so it comes before the
    # placement (`place_dit`)
    state = vdm.init_train_state(
        torch.Generator(device=device).manual_seed(args.global_seed), dit,
        cfg)
    mesh_mod.place_dit(dit, dit.cfg, mesh, args.dit_sharding)
    return run(state, dit, vae["encoder"], vae["decoder"], stitched,
               text_loader=text_loader, video_loader=video_loader,
               embed_text=embed_text, reward_loss_fn=reward_loss_fn,
               reward_text_fn=reward_text_fn, scfg=scfg, cfg=cfg,
               num_steps=args.num_epochs * len(video_loader),
               save_path=args.save_path, save_freq=args.save_freq,
               resume_path=args.resume_checkpoint_path,
               seed=args.global_seed, logger=logger, mesh=mesh)


if __name__ == "__main__":
    main(training_vdm_argument().parse_args())
