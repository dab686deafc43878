"""Entry point: text → 3DGS inference on released checkpoints.

Port of `vist3a_tpu/cli/inference_t23d.py` (the reference's
`inference_t23d.py:51-166`): the prompt list sharded over the data axis
(`prompts[data_index::data_size]`, :62), the fixed seed 12413, 50-step UniPC with
`--flow_shift` and the first `--cfg_scale`, one output folder per prompt
with prompt.txt, the orbit gs.mp4 and depth.mp4 and gaussians.ply.

    python -m vist3a_tpu_torch.cli.inference_t23d \\
        --weights_root checkpoints \\
        --checkpoint_path checkpoints/anysplat_stitched.pth \\
        --transformer_lora_path checkpoints/wan_lora \\
        --stitching_layer_location enc_blocks_16 \\
        --lora_config r64,a32,d0.0,f0 \\
        --input_texts_path prompts.txt --output_dir results

The tokenizer is a callable `tokenize(text) → (ids (1, 226), mask (1,
226))`; `main` loads the HF one from `{weights_root}/umt5` only when none
is given (`transformers` is needed for that alone).

Tensor-parallel (the 14B DiT over M GPUs of a model group), one process
per GPU: `torchrun --nproc_per_node N -m vist3a_tpu_torch.cli.
inference_t23d --mesh_model M ...`.  With `--mesh_model` above 1 the DiT
is placed by `--dit_sharding` (tp by default); the ranks of one model group
take the same prompts, draw the same `latents0` (the seed) and denoise
together, and only its model-rank 0 decodes and writes the scene.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from vist3a_tpu_torch.cli.arguments import inference_vist3a_argument
from vist3a_tpu_torch.pipelines import t23d


def summarize(res: t23d.T23DResult) -> dict:
    """What a caller checks of one request, on the host and small: the
    output paths, the shape and finiteness of the latents and of each
    tensor of the stitched decoder's output, the orbit frames' shape, mean
    and range, and whether the rendered depth is finite.  Python scalars
    and tuples only: the request's device tensors and its orbit frames are
    dropped with `res`."""
    out = res.output
    tensors = {**out.gaussians._asdict(), "depth": out.depth,
               "depth_conf": out.depth_conf,
               "extrinsic_c2w": out.extrinsic_c2w,
               "intrinsic_norm": out.intrinsic_norm}
    arts = res.artifacts
    return {
        "paths": {"gs": arts.gs_path, "depth": arts.depth_path,
                  "ply": arts.ply_path},
        "latents_shape": tuple(res.latents.shape),
        "latents_finite": bool(torch.isfinite(res.latents).all()),
        "shapes": {k: tuple(t.shape) for k, t in tensors.items()},
        "finite": {k: bool(torch.isfinite(t).all())
                   for k, t in tensors.items()},
        "frames_shape": tuple(arts.color.shape),
        "frames_finite": bool(np.isfinite(arts.color).all()),
        "frames_mean": float(arts.color.mean()),
        "frames_range": (float(arts.color.min()), float(arts.color.max())),
        "depth_finite": bool(np.isfinite(arts.depth).all())}


def run(modules: dict, tokenize: Callable, prompts: list[str],
        output_dir: str, cfg: t23d.T23DConfig, *, process_index: int = 0,
        process_count: int = 1, orbit_t: int = 10, writes: bool = True,
        device: torch.device | str = "cuda") -> list:
    """This process's share of `prompts` (`prompts[process_index::
    process_count]`), each through `text_to_3dgs` into
    `output_dir/<prompt[:100] without '/'>/`.  Returns [(prompt,
    `summarize` of its request)]: no scene stays on the card once its
    files are written, as the JAX `run` keeps only the paths.  writes=False
    (a tensor-parallel peer of the writing rank) embeds and denoises each
    prompt with its model group, decodes and writes nothing, and returns
    []."""
    results = []
    for prompt in prompts[process_index::process_count]:
        if not writes:
            cond, uncond = t23d.embed_prompts(modules["umt5"], tokenize,
                                              prompt, device=device)
            t23d.denoise(modules["dit"], cond, uncond, cfg, device=device)
            continue
        save = Path(output_dir) / prompt[:100].replace("/", "")
        save.mkdir(parents=True, exist_ok=True)
        (save / "prompt.txt").write_text(prompt)
        res = t23d.text_to_3dgs(modules, tokenize, prompt, str(save), cfg,
                                orbit_t=orbit_t, device=device)
        results.append((prompt, summarize(res)))
        del res
    return results


def hf_tokenizer(path) -> Callable:
    """The HF UMT5 tokenizer of `path` as `tokenize`, padded to 226."""
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(str(path))

    def tokenize(text):
        enc = tokenizer([text], padding="max_length", max_length=226,
                        truncation=True, add_special_tokens=True,
                        return_attention_mask=True, return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]
    return tokenize


def load_generator(root: Path, model_id: str, lora_path=None, *,
                   device: torch.device | str = "cuda") -> dict:
    """{"umt5": UMT5Encoder, "dit": WanDiT} in bf16 from `{root}/umt5` and
    `{root}/wan_dit`, each checked against its manifest; a PEFT adapter at
    `lora_path` merged into the DiT's sites in fp32 from the file's values,
    each site moved to `device`, merged there and cast to bf16 at once.
    The host holds one file's tensors at a time (28.6 GB at 14B, where the
    fp32 sites alone would be 33.5); the DiT is built before UMT5 is
    placed, so the merged sites (16.8 GB at 14B) and UMT5 (11.4) are not
    on the card together."""
    from vist3a_tpu_torch.io import load_weights, manifests
    from vist3a_tpu_torch.io import weight_import as wi
    from vist3a_tpu_torch.nn import umt5, wan_dit

    sd = manifests.validate_wan_dit(
        load_weights.load_sharded_safetensors(root / "wan_dit"))
    # `--model_id` picks the DiT's widths (`inference_t23d.py:55`), the
    # file its depth
    cfg = wi.dit_config(sd, wan_dit.config_from_model_id(model_id))
    state = wi.import_wan_dit(sd, cfg)
    del sd
    if lora_path:
        state = wi.apply_peft_lora(
            state, load_weights.load_sharded_safetensors(lora_path),
            dtype=torch.bfloat16, device=device)
    dit = wi.build_module(lambda: wan_dit.WanDiT(cfg), state, device=device,
                          dtype=torch.bfloat16)
    del state
    sd = load_weights.load_sharded_safetensors(root / "umt5")
    manifests.validate_state_dict(sd, "umt5_xxl")
    ucfg = umt5.UMT5_XXL
    return {"umt5": wi.build_module(
        lambda: umt5.UMT5Encoder(ucfg), wi.import_umt5(sd, ucfg),
        device=device, dtype=torch.bfloat16), "dit": dit}


def main(args, tokenize: Callable | None = None, *,
         device: torch.device | str = "cuda") -> tuple[dict, list]:
    """The process group of a launcher's environment (`setup_dist`; none
    without one) and the mesh of the flags; every module from the weights
    root and the checkpoints the flags name, the DiT placed over the mesh
    when `--mesh_model` is above 1; then `run` over `--input_texts_path`,
    this rank's prompts by its data index.  Returns the modules and `run`'s
    results; a group this call started is destroyed on the way out."""
    from vist3a_tpu_torch.cli.model_loading import (load_stitched_model,
                                                    weights_root)
    from vist3a_tpu_torch.core import distributed
    from vist3a_tpu_torch.core import mesh as mesh_mod

    started = distributed.setup_dist(device)
    try:
        mesh = mesh_mod.mesh_from_args(args)
        root = weights_root(args)
        modules, scfg = load_stitched_model(args, device=device)
        modules.update(load_generator(
            root, args.model_id, getattr(args, "transformer_lora_path", None),
            device=device))
        if tokenize is None:
            tokenize = hf_tokenizer(root / "umt5")
        with open(args.input_texts_path) as f:
            prompts = [line.strip() for line in f if line.strip()]
        cfg = request_config(args, modules["dit"].cfg, scfg)
        if mesh.model > 1:
            mesh_mod.place_dit(modules["dit"], cfg.dit, mesh,
                               args.dit_sharding)
        return modules, run(modules, tokenize, prompts, args.output_dir, cfg,
                            process_index=mesh.data_index,
                            process_count=mesh.data,
                            writes=mesh.model_index == 0, device=device)
    finally:
        if started:
            distributed.cleanup()


def request_config(args, dit_cfg, scfg, **over) -> t23d.T23DConfig:
    """The T23DConfig of a request from the flags (`--num_frames`,
    `--flow_shift`, the first `--cfg_scale`), the loaded DiT's config and
    the stitched decoder's, with its DPT cascades in bf16 (the inference
    decode; `load_stitched_model`'s config keeps the fp32 setting); `over`
    replaces fields (`num_inference_steps`)."""
    scfg = dataclasses.replace(
        scfg, encoder=dataclasses.replace(scfg.encoder,
                                          head_dtype="bfloat16"))
    return t23d.T23DConfig(
        num_frames=args.num_frames, flow_shift=args.flow_shift,
        guidance_scale=float(str(args.cfg_scale).split(",")[0]),
        dit=dit_cfg, stitched=scfg, **over)


if __name__ == "__main__":
    main(inference_vist3a_argument().parse_args())
