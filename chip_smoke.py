#!/usr/bin/env python3
"""Drive the PyTorch port (`vist3a_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels,raster
    python3 chip_smoke.py --phases device,build,kernels,train
    python3 chip_smoke.py --phases device,build,kernels,raster,vdm
    python3 chip_smoke.py --phases device,build,cli
    python3 chip_smoke.py --phases device,build,cli14b
    python3 chip_smoke.py --phases device,build,distributed
    python3 chip_smoke.py --phases device,build,workflows
    python3 chip_smoke.py --phases device,build,evaluation
    python3 chip_smoke.py --phases device,build,generation

Phases, each of which passes or raises (any failure exits non-zero):
  1. device  — the card's name and power limit; fails without CUDA.
  2. build   — builds `vist3a_tpu_torch/csrc/flash_attention_fwd.cu`,
               `csrc/flash_attention_bwd.cu`, the wgmma + TMA kernels
               `csrc/flash_attention_fwd_sm90.cu` and
               `csrc/flash_attention_bwd_sm90.cu`, their fp32 3×TF32
               counterparts `csrc/flash_attention_fwd_f32_sm90.cu` and
               `csrc/flash_attention_bwd_f32_sm90.cu`,
               `csrc/rasterize_fwd.cu` and `csrc/rasterize_bwd.cu` (which
               share `csrc/raster_common.cuh`) and the DiT's q/k prologue
               `csrc/qk_prologue.cu` for
               sm_90a, one nvcc each, at once, and prints ptxas's
               registers / shared memory / spills and the wgmma kernels'
               dynamic shared memory a block.
  3. kernels — holds the flash-attention kernels against their plain
               PyTorch version at the three shapes of the decode (ViT
               blocks, frame attention, global attention), at the VDM
               step's unmasked global attention (1, 13377, 16, 64) and at
               the Wan DiT's self-attention (2, 4096, 12, 128) and (2,
               4096, 40, 128) (1.3B and 14B heads) — every bf16 call at
               head_dim 64 and 128, masked or not, takes the wgmma kernel —
               plus a ragged (2, 1100, 2, D) and a short (1, 45, 3, D) at
               both head dims, a fully masked, a ragged masked D = 128,
               the mma.sync kernel at D = 40 and 96 (several key tiles, the
               latter masked) and strided cases at D = 64 and 128 (forward
               and backward), each within a limit scaled to its output
               (`O_ATOL_STD`, `O_RTOL`), and times it beside the plain
               version and `F.scaled_dot_product_attention` (a yardstick
               the port never calls).  Then the fp32 forward and the
               backward (kernel 4, both on 3×TF32 tensor cores) on fp32
               inputs at the training step's shapes — (13, 1029,
               16, 64), (1, 13377, 16, 64), (1, 21609, 16, 64) — a ragged
               (2, 1100, 2, 64) and a short (1, 45, 3, 64): O, LSE and the
               three gradients against the plain versions (`F32_*`
               limits), the backward bit for bit repeatable; timed beside
               the plain versions, SDPA's memory-efficient fp32 forward and
               backward (and the names of the kernels it ran) and the
               bounds at the 3×TF32 and the FFMA peaks.  Then the bf16 backward (kernels 4b and 5)
               at the VDM step's shapes — (13, 1029, 16, 64),
               (1, 13377, 16, 64), (1, 4096, 12, 128), (6, 4096, 12, 128),
               the wgmma kernels — a ragged (2, 1100, 2, 64) and (2, 333,
               3, 128), a short (1, 45, 3, 64) and (1, 45, 3, 128), and
               ragged head_dim-96 (2, 333, 3, 96) and head_dim-48 (2, 333,
               3, 48), the mma.sync kernels: each gradient within
               `GRAD_ATOL_STD` of its
               std plus `GRAD_RTOL` of itself, bit for bit repeatable;
               timed beside the plain version, SDPA's bf16 backward (a
               yardstick) and the bound.  Then the DiT's q/k prologue
               kernel (`QK_CASES`: the fused QKV product at 14B and 1.3B
               with RoPE, the cross-attention's q over 4,096 and k over
               226 tokens without) against its plain version within
               `QK_MAX_ULPS`, with the share of elements that differ at
               all, timed beside the plain version and its bytes' bound;
               and its launches over one 14B and one 1.3B DiT forward (3 a
               block; none with grad enabled).  Row 1 also at CogVideoX-5B's
               joint attention (2, 17776, 48, 64), and a 2-step CogVideoX
               denoise at 480×720, 49 frames: 42 `launches_unmasked` a
               forward, no other flash entry.
  4. raster  — one full-width scene: the Gaussians of one stitched-decoder
               request and its 13 context cameras interpolated to the
               133-view orbit.  Holds the composite kernel against its
               plain version on two orbit views at 448² (`RASTER_ATOL`,
               `RASTER_MAX_OFF_SHARE`), prints each view's pair count and
               what the budget cut, times both, and states the kernel's
               bound (the work of the composited (pixel, pair)s; the count
               of every evaluation up to the stop kept as
               `ops_all_evaluated`) and its share of it.  Then the
               composite backward (kernel 7) against `composite_bwd_ref` on
               the same two views at the reward's 1×G pair budget, given a
               random cotangent (`RASTER_BWD_*` limits), bit for bit
               repeatable, timed with its bound.  Logs, per view, figures
               of the plain versions, not of the kernels: the share of
               (warp, pair)s the sub-tile cull keeps (`subtile_mask_ref`)
               and the largest and mean tile walk (`composite_ref`'s
               work counts).  Logs ptxas's registers and spills of both
               composite kernels.
               No PyTorch call computes either function, so their library
               times are null.
  5. slice   — builds the stitched decoder at full width (VGGT-1B /
               DINOv2-L, random weights from a seed, trunk bf16, heads bf16)
               and serves 3 decode requests through `forward_with_latent`:
               Wan latent (1, 16, 4, 64, 64) + images (1, 3, 13, 448, 448)
               → 2,609,152 Gaussians.  Checks shapes, finiteness and that
               each request launched the kernel 8 times unmasked and 48
               times masked.
  6. profile — one more slice request and one more decode request under
               torch.profiler: device time by kernel and group, the
               device's busy share, the host ops, and stage times (the
               slice's synchronised; the decode's from the port's
               `decode.*`, `export.*` and `render.*` profiler ranges).
               Runs after the counts have been read.
  7. reference — a narrow decoder at the full spatial shape, and a narrow
               Wan DiT at the full token count (4096 tokens, 2 heads of
               128, 2 layers), each run on the card (kernel path) and on
               the host CPU (plain path) with the same weights and inputs;
               the outputs must agree.
  8. decode  — the decode half of text→3DGS at full width: the Wan 2.1 VAE
               decoder (bf16) and the stitched decoder from seeds, a
               normalised latent (1, 16, 4, 64, 64) through
               `decode_and_reconstruct` (video (1, 3, 13, 512, 512),
               feed-forward (1, 3, 13, 448, 448), 2,609,152 Gaussians) and
               `export_artifacts` (133 orbit views at 448², one composite
               launch each, gs.mp4 and depth.mp4 written from uint8 frames
               made on the card, the PLY read back).  Two requests; each
               checks the frames handed to the two mp4 writers byte for
               byte against the numpy path on the host copies, and that
               the card converted 266 frames (`frames_on_card`).
  9. denoise — the whole of text→3DGS at full width through `text_to_3dgs`:
               UMT5-XXL and the Wan 2.1 1.3B DiT in bf16 (random weights
               drawn on the card from a seed), a seeded fake tokenizer (226
               ids), 50 UniPC steps with CFG batched to B = 2 (30 natural
               flash launches a step, 1500 a request), then the decode and
               export of phase 8 (8 + 48 flash and 133 composite launches).
               Checks the latents (1, 16, 4, 64, 64), the files and the
               launch counts; prints the ms per denoise step, peak memory,
               a profile of 2 denoise steps and, with `profile`, the host
               and device time of the ranges `t23d.embed` and
               `t23d.denoise` in a prompt embedding and a denoise cut to
               `T23D_PROFILE_STEPS` steps (the decode's ranges are phase
               `profile`'s, in its decode request).
  10. cli    — the command line on reference-format files at full width:
               the whole AnySplat encoder (fp32, the camera trick of
               phase 5), the Wan 2.1 VAE (fp32), UMT5-XXL and the Wan 1.3B
               DiT (bf16) drawn on the card from a seed and moved to the
               host; their reference-named state dicts (the port's
               fabricators, each checked against its manifest) written
               under a temporary weights root in the reference layout
               (`anysplat.pth`, `wan_vae/`, `umt5/` as three HF shards and
               an index, `wan_dit/`), with a stitched checkpoint chopped at
               16 (LoRA r64 α32 with nonzero factors on every site, every
               site's bias, the stitch conv and the tokens) and a PEFT
               adapter (r8 α16, nonzero lora_B) on the DiT's q/k/v/o —
               the free disk read first; then `cli/inference_t23d.py::main`
               with the reference's flags on two prompts.  Checks the
               launches (twice a request's), each prompt's folder
               (prompt.txt, gs.mp4, depth.mp4, gaussians.ply), finite
               latents and Gaussians, and every imported parameter of the
               stitched decoder, the DiT, UMT5 and the VAE decoder equal,
               bit for bit, to what was written (at a LoRA site, the merge
               w + scaling·Δ computed here from the written factors, then
               the cast).  Prints the seconds spent writing, reading and
               importing, each request's latency and the peak memory.
  10b. cli14b — VIST3A-14B from its command line on files
               (`drive_cli14b`): the Wan 2.1 14B DiT (14.3 B parameters,
               bf16) drawn on the card part by part from seeds and written
               as 41 diffusers shards, a PEFT adapter r8 α16 on its 320
               sites, `anysplat.pth` with a VGGT-shaped point head, and
               phase `cli`'s UMT5, VAE and stitched checkpoint (linked; run
               alone, written here first).  `load_stitched_model`,
               `load_generator(model_id=CLI14B_MODEL_ID)` and
               `inference_t23d.run` on one prompt at CLI14B_STEPS UniPC
               steps with CFG: the folder (prompt.txt, gs.mp4, depth.mp4,
               gaussians.ply with 2,609,152 Gaussians) and every DiT
               tensor equal, bit for bit, to its part drawn again (merged
               where the adapter is, each site also within half a bf16
               spacing of a float64 merge).  Then the validation views of that
               request (`render_validation`: `viz.render_projections` at
               512² with its pairs against the render's budget,
               `render_camera_poses`, a 60-view wobbling interpolation
               through `render`, its depth through
               `apply_color_map_to_image`, laid out and written as
               validation.png; the drawing and the colour map card vs host
               CPU); one 14B block at 4096 tokens through the kernel route
               and through `plain_attention` on the card (`block_check_14b`:
               the self-attention's output on the block's own q, k, v and
               the block's output, each within 2⁻⁵ of its range); the
               stitched decoder with the point head (`drive_point_decode`:
               the head as written, one decode, the depth the points' z)
               and a narrow point-head decoder card vs host CPU.  Logs the
               stages' spans, the memory, ms per denoise step,
               the host's peak resident set while the DiT loaded, the
               bytes and the launches (paths `cli14b` and `cli14b_point`).
  11. train — stitching distillation at full width, fp32 (TF32 off):
               the teacher (the whole `EncoderConfig()` encoder, ~1.19 B
               parameters), the stitch conv and the Wan 2.1 VAE encoder
               drawn on the card from a seed; LoRA r64,a32; two steps of
               `cli.train_stitching.run` over a synthetic clip (1, 3, 21,
               512, 512) and its 448² resize, at S = 13 then S = 21 (the
               seed is the first whose draws give those).  Checks finite
               losses and grad_norm > 0, the B factors moved after the
               step with lr > 0, the teacher's weights unchanged and the
               student's frozen tensors its own, and per step 184 unmasked
               flash launches (fp32, on the 3×TF32 kernels: 112 at the
               ViT/frame shape, 72 global) and 56 backward (32 and 24);
               prints ms per step,
               peak memory, a profile of one more step at S = 13, and
               compares a narrow step on the card with the host CPU.  The
               run saves its epoch (`save_path`); the save is reloaded into
               a fresh state and held against the live one, tensor by
               tensor (no step is taken for it).
               Cut: B = 1 and two steps; random weights, no data loader.
  12. vdm    — reward-aligned VDM fine-tuning at full width: one step of
               `cli.train_vdm.run` (`VDMTrainConfig()`: LoRA r8 α16 on the
               Wan 2.1 1.3B DiT's attention, bf16; UMT5-XXL for the prompts
               with the stand-in tokenizer of phase `denoise`; the Wan VAE
               in fp32 weights with bf16 activations; the stitched decoder
               bf16; both CLIP-H vision towers, fp32; all drawn on the card
               from seeds) over a synthetic clip (1, 3, 13, 512, 512) and
               random L2-normalised scorer text features.  Step 0 takes the
               50-step rollout (every 10th step; a second step, of a drawn
               and bucketed length, was cut in PR 15 for phase
               `distributed`).  Checks finite losses, grad_norm > 0, no
               skip, the LoRA B factors moved, the EMA at its warm-up
               formula, the frozen weights unchanged, and each step's
               launches against `vdm_launches` (56 kernel-4b, 60 kernel-5
               and 13 composite backward launches); prints ms per step,
               peak memory, and compares a narrow step card vs host CPU (the
               SFT gradients and the losses) and its reward branch alone,
               in fp32 and in bf16, with the host's render inputs, pair
               streams and the render's cotangents pinned to the card's
               (the gradients with respect to the latent and the decoded
               clip, the render's cotangents apart), counting card vs host
               the members of the sets the render's thresholds select.
               The run saves `checkpoint-1` (`save_freq`), reloaded into
               a fresh state and held against the live one as in phase 11.
               Cut: B = 1, one step, random weights and data.
  13. distributed — the multi-GPU layer (`core/distributed.py`,
               `core/mesh.py`) on the card at world 1: the environment of a
               one-rank `torchrun` (`launcher_env`), `setup_dist` (NCCL,
               the rank pinned to its device), a 1×1 mesh and a one-tensor
               all-reduce; then, each against its plain step from the same
               seed, one full-width fp32 distillation step at 9 views
               through `run` under DDP, one VDM SFT step of the 1.3B DiT
               (bf16, a 13-frame 512² clip) under each of `fsdp`, `tp`,
               `tp_fsdp` and `replicated`, and a 2-step denoise under `tp`;
               each maximum |wrapped − plain| must be 0 (at world 1 every
               collective is a copy; the distillation steps with cuDNN's
               deterministic algorithms, and the plain step once more with
               its default ones, to log their run-to-run spread) and each
               wrapped step's launches as the plain path's.  `cleanup` at
               the end.
  14. workflows — the three workflows from their command lines at full
               width on files on disk (`drive_workflows`): phase `cli`'s
               source modules plus both scorers' towers (PickScore: HF
               CLIP-H/14 at 224²; DFN5B: open_clip H/14 at 378²; each with
               a CLIP-H text tower; fp32) written in the reference layout
               (`pickscore/` with `logit_scale` and a synthetic `vocab.json`
               + `merges.txt`, `dfn5b/`; ~28 GB, the free disk read first),
               a DL3DV tree (1 captioned scene × 21 structured frames at
               960×540, PNG), a one-scene ScanNet tree and a
               prompt list; then `cli/find_layer.py::main` on 1 DL3DV
               sample (24 MSEs, 24 artifacts, the printed argmin, a
               second main from the cache, the last tap against the
               trunk's own blocks, 24 fp32 flash launches a sample),
               `cli/train_stitching.py::main` over DL3DV + ScanNet from the
               search's `enc_blocks_16` artifact (converted to the {weight,
               bias} `.pth` the main reads; LoRA r64 α32, B = 1, one epoch
               of 2 steps at the seed whose views are 13, 9: finite
               losses, the teacher unchanged, the epoch's checkpoint, the
               JSONL metric stream's 16 terms, phase `train`'s launches a
               step) and `cli/train_vdm.py::main --enable_rl` for one step
               (the 50-step rollout of every 10th step: finite losses, the
               per-prompt text features of the imported towers finite, unit
               norm and the source towers', the frozen modules as written,
               `history.jsonl`, `images/step_000000.png`, `checkpoint-1`,
               `vdm_launches(50)`, the DiT under `--dit_sharding fsdp`).
               The distillation and VDM mains run under a one-rank
               torchrun's environment, so each starts NCCL through
               `setup_dist` and destroys it; each must leave nothing
               allocated once its results are dropped.  Logs each main's
               read, load, step and extraction seconds, the host fit's
               seconds, the feature cache's bytes, the peak memory and the
               memory allocated before and after it.  Cut: random
               weights, synthetic scenes and tokenizer files, a few steps,
               one search sample.
  15. evaluation — RE10K novel-view synthesis from its command line and
               per-scene refinement, at full width (`drive_evaluation`):
               the whole AnySplat encoder (fp32, the camera trick) and the
               Wan 2.1 VAE drawn on the card from a seed and written as
               `anysplat.pth` and `wan_vae/` (fp32) with a stitched
               checkpoint chopped at 16 (LoRA r64 α32), no UMT5 or DiT;
               a synthetic RE10K tree (2 sequences × 16 PNG frames at
               640×360 of moving blobs, `annotations.json` with 3×4
               extrinsics on a short arc, a `seq_id_map` of all 16 ids);
               then `cli/nvs_eval.py::main --resolution 512
               --feedforward_resolution 448`: per sequence pass 1 on the
               12 context views and a duplicate (S = 13, 2,609,152
               Gaussians), pass 2 with the 4 targets (S = 17), 4 target
               renders at 448².  Checks the launches (per sequence 16 ViT,
               96 masked, 4 composite), 4 gt and 4 pred PNGs a sequence,
               both CSVs, their PSNR and SSIM finite and equal to this
               script's float64 recomputation from the PNGs
               (`EVAL_PSNR_ATOL`, `EVAL_SSIM_ATOL`), and LPIPS of the
               first sequence's PNGs with seeded random VGG16 weights on
               the card against the host CPU (`EVAL_LPIPS_RTOL`).  Then
               `train/post_opt.py::refine` of the first sequence's pass-1
               Gaussians against its 12 context views at 448² for 50
               steps (pose refinement on, the default pair budget):
               finite losses, the mean of the last 10 below the mean of
               the first 5, one composite launch forward and one backward
               a step; and a narrow refine (the 48-Gaussian scene of
               `tests/test_post_opt.py` at 32², 4 steps, the views handed
               in) card vs host CPU (`POST_OPT_*` limits).  Logs the
               seconds to write, load, wait for host data (the numpy
               Lanczos resizes), VAE-encode, run each forward, render,
               write and score, the seconds a refine step, and the peak
               memory.  Cut: random weights, synthetic scenes, 50 steps.
  16. generation — the generation-quality evaluation from its command
               line at full width (`drive_generation`): the Qwen2.5-VL-7B
               judge (bf16, 7B `config.json`, 4 safetensors shards), CLIP
               ViT-L/14 at 224² and LongCLIP-L (text context 248) as HF
               CLIPModel folders (fp32, quick GELU, a synthetic vocab.json
               + merges.txt), the aesthetic probe (768 → 1, `.npy`) and
               MUSIQ-SPAQ (`.npz`), drawn on the card from a seed and
               written in those layouts (the free disk read first), over
               phase `cli`'s two request folders (prompt.txt, gs.mp4 of 133
               orbit views at 448²; run alone, one request through
               `inference_t23d.run` with the denoise cut to
               `T23D_PROFILE_STEPS` steps).  Then `gen_eval.main(["t3",
               ...])` with every scorer but the judge (8 frames a folder):
               finite scores, CLIPScore and LongCLIP in [0, 100], the JSON
               equal to the summary printed; `gen_eval.main(["dpg", ...])`
               with the judge and a stand-in tokenizer (2 prompts × 3
               questions, one depending on another, 2 frames: 12 judge
               calls): `dpg_score` in [0, 100] and equal to a recomputation
               from the recorded answers with the dependency zeroing, the
               judge's every tensor equal to what was written; one
               unified-reward call cut to 64 new tokens on one frame; no
               kernel of the repo launched.  Card vs host CPU: the tiny
               judge (fp32: the same greedy tokens, logits within 1e-4),
               the 7B judge cut to 2 vision blocks and 2 text layers (bf16
               vs fp32: the prefill's logits within
               `GEN_NARROW_LOGITS_RTOL`), CLIPScore, LongCLIP, the
               aesthetic score and MUSIQ at full width (fp32, TF32 off:
               within 1e-4; CLIPScore and LongCLIP by their per-frame
               cosines before the clamp at 0).  Logs the bytes and seconds written, read and
               imported, the seconds per scorer per folder, the judge's
               vision tower, prefill and per-token ms, the peak memory and
               the launches.  Cut: random weights, stand-in tokenizer and
               vocabularies, the unified-reward call (deployed: 1,024
               tokens on each of 8 frames).
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

PHASES = ("device", "build", "kernels", "raster", "slice", "profile",
          "reference", "decode", "denoise", "cli", "cli14b", "train", "vdm",
          "distributed", "workflows", "evaluation", "generation")
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
# fp32-accurate products on the TF32 tensor cores (495 TFLOP/s dense), each
# three TF32 products (3×TF32: big·big + big·small + small·big)
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
# the wgmma + TMA kernels of the bf16 calls at head_dim 64 and 128, masked
# or not (rows 1 bf16, 2 and 3, kernels 4b and 5)
SM90_SOURCE = "vist3a_tpu_torch/csrc/flash_attention_fwd_sm90.cu"
SM90_BWD_SOURCE = "vist3a_tpu_torch/csrc/flash_attention_bwd_sm90.cu"
# the 3×TF32 wgmma + TMA kernels of every fp32 call (row 1 fp32, kernel 4)
F32_SOURCE = "vist3a_tpu_torch/csrc/flash_attention_fwd_f32_sm90.cu"
F32_BWD_SOURCE = "vist3a_tpu_torch/csrc/flash_attention_bwd_f32_sm90.cu"
RASTER_SOURCE = "vist3a_tpu_torch/csrc/rasterize_fwd.cu"
# Flash kernel vs its plain version, elementwise:
#   |ΔO| ≤ O_ATOL_STD · std(O_ref) + O_RTOL · |O_ref|.
# O is a softmax average, so its scale falls with N (std ≈ sqrt(e/N) on
# unit-normal inputs: 0.026 at N = 4096) and a fixed limit would be loose
# at large N.  Both sides store O in bf16, so an element may differ by one
# bf16 step, up to 2⁻⁷·|O| — and a few keys carry much of a row's weight,
# so the largest |O| lie far out in the tail (0.5-1 at N = 1029, 10 std);
# O_RTOL = 2⁻⁶ is two such steps.  The atol term covers P, rounded to bf16
# before the PV product (2⁻⁹ of each key's share), for elements near 0.  A
# PV-side fault that leaves the LSE alone (a skipped key tile, an
# unrescaled accumulator, a shifted V tile) removes or moves a whole key's
# share; `tools/torch_flash_mutants.py` plants such faults and checks that
# this limit catches them.
O_ATOL_STD = 0.1
O_RTOL = 2 ** -6
LSE_ATOL = 1e-3   # fp32 statistics; only the summation order differs
# The fp32 forward and the backward (kernel 4) against their plain versions
# on fp32 inputs: both sides compute to about fp32's accuracy (the kernels
# as 3×TF32 products, 2⁻²¹ of each product), in another order, summing
# over up to 21,609 keys (the backward's gradients sum twice as many
# products: a dS term, then a tile loop), so O within 2e-5 of its largest
# magnitude, each gradient within 1e-4 of its, LSE within 1e-5 (values
# ~10).  One TF32 product (no corrections) misses all of them by 10× or
# more (`tests/test_torch_tf32_split.py`).
F32_O_RTOL = 2e-5
F32_GRAD_RTOL = 1e-4
F32_LSE_ATOL = 1e-5
# (name, (B, N, H, D)): the training step's ViT and frame attention, its
# global attention at S = 13 and S = 21 (the largest view count), a ragged
# N and an N below one 64-row tile
F32_CASES = (("f32_vit_frame", (13, 1029, 16, 64)),
             ("f32_global_s13", (1, 13377, 16, 64)),
             ("f32_global_s21", (1, 21609, 16, 64)),
             ("f32_ragged", (2, 1100, 2, 64)),
             ("f32_short", (1, 45, 3, 64)))
F32_TIMED = ("f32_vit_frame", "f32_global_s13", "f32_global_s21")
# The bf16 backward (kernels 4b and 5) against the plain version, which
# computes in fp32 from the same bf16 inputs, elementwise for each gradient:
#   |Δ| ≤ GRAD_ATOL_STD · std(ref) + GRAD_RTOL · |ref|.
# The kernel rounds P and dS to bf16 before the products (as the TPU
# kernels do; 2⁻⁹ of each term, summed with random signs over N terms: a
# small share of the gradient's std) and stores the gradients in bf16 (one
# step, up to 2⁻⁸·|ref|); GRAD_RTOL is two such steps.  A dropped δ or a
# skipped tile moves a gradient by a large share of its largest element.
GRAD_ATOL_STD = 0.05
GRAD_RTOL = 2 ** -6
# (name, (B, N, H, D)): the VDM step's stitched-decoder ViT/frame and global
# attention (kernel 4b) and its DiT self-attention in the SFT branch and in
# the rollout's re-evaluation (kernel 5), all on the wgmma kernels; ragged
# N at both head dims, N below one tile at both, and head_dims 96 and 48
# (the mma.sync kernels' D = 128 and D = 64 instantiations, which the wgmma
# kernels left to the other head dims)
BF16_BWD_CASES = (("bf16_vit_frame", (13, 1029, 16, 64)),
                  ("bf16_global_s13", (1, 13377, 16, 64)),
                  ("bf16_dit_sft", (1, 4096, 12, 128)),
                  ("bf16_dit_reeval", (6, 4096, 12, 128)),
                  ("bf16_ragged_d64", (2, 1100, 2, 64)),
                  ("bf16_ragged_d128", (2, 333, 3, 128)),
                  ("bf16_short", (1, 45, 3, 64)),
                  ("bf16_short_d128", (1, 45, 3, 128)),
                  ("bf16_ragged_d96", (2, 333, 3, 96)),
                  ("bf16_ragged_d48", (2, 333, 3, 48)))
BF16_BWD_TIMED = ("bf16_vit_frame", "bf16_global_s13", "bf16_dit_sft",
                  "bf16_dit_reeval")
# The Wan DiT's q/k prologue kernel (`csrc/qk_prologue.cu`) at the DiT's
# shapes: (name, B, N, width d, heads, parts, RoPE) — the self-attention's
# fused QKV product at 14B and 1.3B (q and k normed and rotated, v biased),
# the cross-attention's q over the 4,096 latent tokens and k over the 226
# text tokens (one part, no tables)
QK_CASES = (("qk_self_14b", 2, 4096, 5120, 40, 3, True),
            ("qk_self_1_3b", 2, 4096, 1536, 12, 3, True),
            ("qk_cross_q_14b", 2, 4096, 5120, 40, 1, False),
            ("qk_cross_k_14b", 2, 226, 5120, 40, 1, False),
            ("qk_cross_q_1_3b", 2, 4096, 1536, 12, 1, False),
            ("qk_cross_k_1_3b", 2, 226, 1536, 12, 1, False))
QK_GRID = (4, 32, 32)         # the latent grid of 512², 13 frames
# The kernel against its plain version on the same inputs, in bf16 ulps at
# each element's magnitude (`qk_ulps`).  The bias add and RoPE are the same
# arithmetic at the same rounding points; the RMS statistic differs in its
# sum's order and rsqrt's last bits, ~1e-6 of itself, far below one bf16
# step.  So a normed element lands one step off, or none, where its fp32
# value lies near a rounding boundary: the normed parts before RoPE (the
# kernel launched without tables) within QK_MAX_ULPS, the kernel's RoPE
# equal bit for bit to `apply_rope` of those, a part with its bias only
# bit-equal.  (After RoPE a one-step input difference is rotated and
# rounded again: up to ~1.5 steps of the pair's norm, logged as
# `rotated_ulps`.)
QK_MAX_ULPS = 1.0
QK_SOURCE = "vist3a_tpu_torch/csrc/qk_prologue.cu"
RASTER_BWD_SOURCE = "vist3a_tpu_torch/csrc/rasterize_bwd.cu"
# The composite backward against its plain version, both fp32, per pair
# and column of the (P, 10) gradient rows: within RASTER_BWD_RTOL of the
# column's largest magnitude on all but RASTER_BWD_MAX_OFF_SHARE of the
# pairs — the sums run over 256 pixels in another order, and where the
# 1e-4 stop fires one pair apart (see RASTER_ATOL) every later pair of
# that pixel's tile sees another suffix — and every element within
# RASTER_BWD_MAX_REL of its column's largest: a pixel stopping one pair
# apart moves a row by about one pair's weight, while a fault in dα moves
# the rows it touches by a large share of the column (the T_final
# cotangent dropped: 0.26-0.41 of it, on 0.15 % of the pairs of a random
# scene).
RASTER_BWD_RTOL = 1e-3
RASTER_BWD_MAX_OFF_SHARE = 1e-3
RASTER_BWD_MAX_REL = 1e-2
# The narrow VDM step, card against host CPU (`vdm_reference`): the loss
# terms, and the SFT branch's gradients (‖Δ‖/‖g‖ over every LoRA factor).
# Both sides run the DiT in bf16 and the VAE in bf16 activations, rounding
# at other places; the limits separate that from a kernel fault, which
# moves a loss or a gradient by O(1).
VDM_REF_LOSS_RTOL = 2e-2
VDM_REF_GRAD_RTOL = 1e-2
# The narrow reward branch alone (`narrow_reward_grads`), card against
# host, the host's render inputs and the render's cotangents pinned to the
# card's: its gradients (‖Δ‖/‖g‖) with respect to the latent through the
# stitched decoder, to the decoded clip, and to the latent through both
# (the decode's backward too), with the stitched trunk and the VAE
# activations in fp32 and in the deployed bf16.  Unpinned, rounding moves
# pixels across the render's thresholds and the gradients by ~0.1 in fp32
# and ~1 in bf16 (`tools/torch_reward_sensitivity.py`); pinned, what is
# left is the decoder's and the decode's rounding, where a dropped or
# misrouted gradient moves them by O(1).  In bf16 the whole latent's
# gradient carries the bf16 VAE decode's backward, cuDNN's convolutions
# against the host's, whose forward already differs by a few per cent.
# `render`: the cotangents that the render and the CLIP towers hand the
# Gaussians and cameras, card vs host from the same inputs and, since the
# pair streams are pinned too, the same (tile, Gaussian) pairs: left free,
# the pair budget's cut moved 550-2,228 of the 65,536 kept pairs a view
# (each tile bbox is a ceil/floor of fp32 values that the two sides round
# apart) and the cotangents by 0.152 (fp32) and 0.111 (bf16); pinned they
# agree to 8.7e-4 and 2.5e-3, what is left being the per-pixel α ≥ 1/255
# cut flipping at 5-15 pixels a view (the attribute tables themselves
# agree to 6.9e-7 of each column).  A lost or misrouted render gradient
# moves them by 1 (pinned, the held gradients above cannot see it).
VDM_REF_REWARD_GRAD_RTOL = {
    "fp32": {"stitched": 1e-3, "video": 1e-3, "latent": 1e-3,
             "render": 1e-2},
    "bf16": {"stitched": 0.1, "video": 1e-3, "latent": 0.2,
             "render": 2.5e-2}}
# pairs a view of the narrow step renders: the host's plain composite,
# forward, recompute and backward over 5 views, is its slowest part
VDM_REF_PAIRS = 1 << 16
# views the narrow reward branch renders when it runs alone, of the step's 5
VDM_REF_REWARD_VIEWS = 2
# Composite kernel vs its plain version, both fp32: each plane within
# 1e-4 of its own scale (1 for colour, alpha, T; the largest depth for
# depth), on all but 0.1 % of the pixels — the 1e-4 stop can fire one pair
# apart under another order of fp32 rounding (the plain version's cumprod
# is a parallel scan on the card), and such a pixel differs by up to the
# weight of that pair.
RASTER_ATOL = 1e-4
RASTER_MAX_OFF_SHARE = 1e-3
# fp32 operations the composite does per (pixel, evaluated pair): dx, dy,
# σ (9), −σ, exp, o·exp; and per composited pair: min, 1−α, T·(1−α), α·T,
# four multiply-adds (8) and the alpha sum.
OPS_PER_EVAL = 14
OPS_PER_COMPOSITE = 13
# fp32 operations of the backward per composited (pixel, pair), beyond the
# evaluation's (OPS_PER_EVAL): of the forward's step only min, 1−α,
# T·(1−α) and w = α·T (4; colour, depth and alpha are read from the saved
# output), then gp (8), the prefix (2), dα (5), dσ (2), the mean, conic
# and opacity gradients (21), the colour and depth gradients (4), and the
# sum over the tile's pixels of the 10 values (10).  A pair whose α was
# clamped has no dα: it skips dα, dσ, the 6 geometry gradients and their
# sums (34).
OPS_BWD_PER_COMPOSITE = 4 + 52
OPS_BWD_CLAMP_SKIPS = 5 + 2 + 21 + 6
IMAGE = 448
ORBIT_T = 10
ORBIT_VIEWS = (13 - 1) * (ORBIT_T + 1) + 1       # 133
RASTER_VIEWS = (5, 71)     # in-between orbit views: frames 0-1 and 6-7
DECODE_REQUESTS = 2
# the distillation phase: two steps through `run`, at these view counts,
# from one clip in [−1, 1] (its 448² resize feeds the students and teacher)
TRAIN_VIEWS = (13, 21)
TRAIN_CLIP = (1, 3, 21, 512, 512)
TRAIN_LORA = "r64,a32,d0.0,f0"
# flash launches a step: the teacher's 24 ViT blocks and 24 frame + 24
# global attentions; the student's 8 ViT blocks (after the chop at 16) and
# 48 trunk attentions, once forward and once more in the recompute; and
# one backward for each of the student's
TRAIN_LAUNCHES = {"unmasked": 72 + 2 * 56, "masked": 0, "natural": 0,
                  "backward": 56}

# the VDM phase: two steps through `cli.train_vdm.run` on one synthetic
# clip, the rollout prompt and caption embedded by UMT5-XXL
VDM_CLIP = (1, 3, 13, 512, 512)
VDM_CAPTION = "a wooden chair on a lawn, the camera circles it"
VDM_SEED = 23
VDM_STEPS = 1

# phase `distributed`: one rank of a torchrun launch (NCCL, a 1×1 mesh):
# a distillation step at this many views, a VDM SFT step under each
# placement, a denoise of this many steps under TP, each against its plain
# step from the same seed; at world 1 every collective is a copy, so the
# wrapped steps must equal the plain ones bit for bit (the distillation
# step's with cuDNN's deterministic algorithms: its default ones move the
# stitch conv's weight gradient from run to run)
DIST_VIEWS = 9
DIST_SEED = 61
DIST_DENOISE_STEPS = 2
DIST_MAX_ABS_DIFF = 0.0

REQUESTS = 3
GAUSSIANS = 13 * 448 * 448
LAUNCHES_PER_REQUEST = {"unmasked": 8, "masked": 48}
# A pose-branch bias that puts a random-weight decoder's cameras at a real
# pose (unit-ish quaternion, FoV ≈ 0.8 rad after 4 refinements): near-zero
# quaternions and ReLU-clipped FoVs make the camera outputs ill-conditioned,
# the narrow comparison meaningless and the orbit views empty.
CAMERA_BIAS = (0.05, -0.05, 0.5, 0.02, 0.03, 0.01, 0.25, 0.2, 0.2)
# The full-width model's pose-branch weight is scaled by this, so the 13
# frames keep distinct cameras near the bias pose (see `build_stitched`).
CAMERA_WEIGHT_SCALE = 0.05
# The decode request's profiler ranges (the port's `record_function`
# names): the top-level stages in request order, then the per-view stages
# of the render, which lie inside `export.render`.
DECODE_STAGES = ("decode.vae", "decode.resize", "decode.stitched",
                 "export.cameras", "export.render", "export.frames_to_host",
                 "export.colour_uint8", "export.turbo_uint8",
                 "export.mp4_write", "export.ply")
RENDER_STAGES = ("render.project_sh_table", "render.pairs",
                 "render.composite", "render.background")
# the stages of phase `denoise`'s profiled prompt embedding and denoise
T23D_STAGES = ("t23d.embed", "t23d.denoise")
# the functions of a request `text_to_3dgs` calls, timed one by one
T23D_REQUEST_STAGES = ("embed_prompts", "denoise", "decode_and_reconstruct",
                       "export_artifacts")
# the denoise steps of phase `denoise`'s profiled prompt embedding and
# denoise: the profile's event walk takes host time per launch (~2.5 s a
# denoise step), and the profile `denoise_2_steps` covers the steps alone
T23D_PROFILE_STEPS = 1
PROMPT = "a red chair in a garden"
# phase `cli`: two prompts, the second with a "/" that its folder name drops
CLI_PROMPTS = (PROMPT, "a wooden boat on a calm lake, seen from bow/stern")
# the stitched checkpoint's LoRA: the reference's stitching recipe
CLI_LORA_SPEC = TRAIN_LORA
# the DiT's PEFT adapter: rank and α of the reference's VDM recipe, which
# `apply_peft_lora` merges by default; the phase's own merge takes α/r
CLI_DIT_LORA_RANK = 8
CLI_DIT_LORA_ALPHA = 16
# the UMT5 safetensors are written as this many shards and an index
CLI_UMT5_SHARDS = 3
# free disk asked of the temporary folder, as a multiple of the files' size
CLI_DISK_FACTOR = 1.2
# phase `cli14b`: the paper's second model, VIST3A-14B, from its command
# line: the Wan 2.1 14B DiT (drawn part by part: the DiT outside its
# blocks from CLI14B_SEED, block i from CLI14B_SEED + 1 + i), one prompt
CLI14B_MODEL_ID = "Wan-AI/Wan2.1-T2V-14B-Diffusers"
CLI14B_PROMPT = "a stone lighthouse on a cliff above the sea at dusk"
CLI14B_SEED = 43
# phase `cli14b`'s stages, each a span (`core/profiling.span`)
CLI14B_STAGES = ("write.dit", "write.other", "load.stitched",
                 "load.generator", "request", "viz.projections",
                 "viz.trajectory", "viz.color_map", "viz.camera_poses",
                 "viz.camera_poses_host", "viz.layout", "check.dit")
# the request's UniPC steps, cut from the deployed 50 so that the whole
# script stays near ~950 s: the phase logs the ms a step (824.8 at 50 steps
# alone on an H100 at 700 W), and a 50-step request takes 50 × that plus
# the rest
CLI14B_STEPS = 10
# VGGT-1B's point head, added to `anysplat.pth`
CLI14B_POINT_SEED = 47
# the validation views: `render_projections` and `render_camera_poses` at
# 512², a wobbling interpolation of CLI14B_TRAJECTORY views at 448², of
# which CLI14B_TRAJECTORY_SHOWN (and 4 as red cameras) are laid out
CLI14B_VIEWS = 512
CLI14B_TRAJECTORY = 60
CLI14B_TRAJECTORY_SHOWN = 4
# the wobble's radius, of the scene's scale (the mean distance of the
# points from the origin)
CLI14B_WOBBLE = 0.05
# drawing, card vs host CPU: the alphas are clip(r − distance + ½) of fp32
# pixel coordinates up to the resolution, each rounded to ~res·2⁻²⁴ and
# summed in other orders; 8 such roundings, 2.4e-4 at 512²
CLI14B_DRAW_ROUNDINGS = 8
# disk asked besides `anysplat.pth` (the adapter, the results)
CLI14B_EXTRA_BYTES = 2 << 30
# host memory asked, as a multiple of the DiT's bytes: its shards in
# /dev/shm, the loader's copy of them (the merged sites come after it is
# freed) and `anysplat.pth` with the point head
CLI14B_RAM_FACTOR = 2.3
# the 14B DiT's shards go to a memory-backed folder, as the card machine's
# disk takes ~45 GiB of writes a call (`shard_parent`); the folder's name
# holds the writing process's id, so that a later run removes the shards
# of a run killed before its cleanup (`sweep_stale_shards`)
CLI14B_SHARD_PREFIX = "vist3a_cli14b_dit_"
# phase `workflows`: the three command lines on files on disk.  The DL3DV
# tree: 1 scene of 21 frames at DL3DV's `images_4` size, captioned over
# frames 0-14 (2 scenes before PR 15: the distillation's third step, ~30 s
# of host data, was cut for phase `distributed`); a one-scene ScanNet
# tree; two prompts
WORKFLOW_DL3DV_SCENES = 1
WORKFLOW_FRAMES = 21
WORKFLOW_HW = (540, 960)
WORKFLOW_SCANNET_HW = (480, 640)
WORKFLOW_CAPTION_FRAMES = 15
WORKFLOW_PROMPTS = (PROMPT, "a wooden boat on a calm lake")
# the distillation main's two steps (1 DL3DV + 1 ScanNet clip, B = 1):
# the drawn view counts the seed is chosen for
WORKFLOW_STITCH_VIEWS = (13, 9)
# the search's samples and the deployed chop the distillation starts from
WORKFLOW_SEARCH_SAMPLES = 1
WORKFLOW_CHOP = 16
# PickScore's logit scale (the file holds its log; the reward takes exp)
PICK_LOGIT_SCALE = 100.0
# the extra disk the phase's data, features and checkpoints take
WORKFLOW_EXTRA_BYTES = 4 << 30
# what a main may leave allocated once its results are dropped: the
# tables its `lru_cache`s keep on the card (RoPE, UV embeddings; a few MB
# each) and cuBLAS workspaces, far below a module (PR 14 left 6.64 GB)
LEFT_BEHIND_BYTES = 256 << 20
# phase `evaluation`: RE10K novel-view synthesis and per-scene refinement
EVAL_SEQUENCES = 2
EVAL_FRAMES = 16               # ids per sequence: 12 context + 4 targets
EVAL_HW = (360, 640)           # RE10K's frame size
EVAL_RESOLUTION = 512          # --resolution (the VAE's)
EVAL_FF_RESOLUTION = 448       # --feedforward_resolution
EVAL_TARGETS = 4
EVAL_LORA = TRAIN_LORA
# per sequence: two stitched forwards (S = 13 and 17), 4 target renders
EVAL_LAUNCHES_PER_SEQUENCE = {"unmasked": 2 * 8, "masked": 2 * 48,
                              "composite": EVAL_TARGETS}
EVAL_PSNR_ATOL = 1e-4          # dB: the CSV's fp32 against float64
EVAL_SSIM_ATOL = 1e-5
EVAL_LPIPS_RTOL = 1e-4         # card vs host CPU, fp32 with TF32 off
EVAL_LPIPS_SEED = 53
POST_OPT_STEPS = 50
POST_OPT_SEED = 0
POST_OPT_NARROW_STEPS = 4
POST_OPT_NARROW_VIEWS = (2, 1, 0, 1)
POST_OPT_LOSS_RTOL = 1e-4      # the narrow refine, card vs host CPU
# each refined parameter within this share of its group's Adam travel
# (lr·steps): a gradient at the noise floor moves its parameter by up to
# lr a step either way, a wrong one by O(lr) everywhere
POST_OPT_PARAM_ADAM_SHARE = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """A failed check ends the run (unlike `assert`, also under -O)."""
    if not ok:
        raise AssertionError(msg)


def cuda_events_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name


def phase_build() -> None:
    from vist3a_tpu_torch.kernels import build
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import qk_prologue as qkp
    from vist3a_tpu_torch.kernels import rasterizer as tr

    sources = (fa.SOURCE, fa.BWD_SOURCE, fa.SM90_SOURCE, fa.SM90_BWD_SOURCE,
               fa.F32_SOURCE, fa.F32_BWD_SOURCE, tr.SOURCE, tr.BWD_SOURCE,
               qkp.SOURCE)
    t0 = time.perf_counter()
    build.build_all(list(sources))
    qkp._lib()
    fa._lib()
    fa._bwd_lib()
    fa._sm90_lib()
    fa._sm90_bwd_lib()
    fa._f32_lib()
    fa._f32_bwd_lib()
    tr._lib()
    tr._bwd_lib()
    log(f"build: {', '.join(sources)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for source in sources:
        text = build.build_logs.get(source, "(library already built)")
        for line in text.splitlines():
            if any(t in line.lower() for t in ("ptxas", "spill", "error")):
                log(f"  {source}: {line.strip()}")
    fwd, bwd = fa._sm90_lib(), fa._sm90_bwd_lib()
    fwd32, bwd32 = fa._f32_lib(), fa._f32_bwd_lib()
    smem = {f"D={d}": {"fwd": fwd.flash_attention_fwd_sm90_smem(d),
                       "bwd_dkv": bwd.flash_attention_bwd_sm90_smem(d, 0),
                       "bwd_dq": bwd.flash_attention_bwd_sm90_smem(d, 1)}
            for d in (64, 128)}
    smem["fp32 D=64"] = {
        "fwd": fwd32.flash_attention_fwd_f32_sm90_smem(64),
        "bwd_dkv": bwd32.flash_attention_bwd_f32_sm90_smem(64, 0),
        "bwd_dq": bwd32.flash_attention_bwd_f32_sm90_smem(64, 1)}
    log("  wgmma kernels' dynamic shared memory a block (bytes): "
        + json.dumps(smem))


@dataclasses.dataclass
class Case:
    name: str
    b: int
    n: int
    h: int
    d: int
    n_invalid: int          # pad keys per frame of `frame_len`
    frame_len: int = 0      # 0: the pad keys sit at the end of the sequence

    @property
    def natural(self) -> bool:
        """Counted as the natural-layout entry: unmasked, head_dim 128."""
        return self.n_invalid == 0 and self.d == 128


def _key_valid(case: Case, device):
    import torch

    if case.n_invalid == 0:
        return None
    if case.frame_len:
        frame = torch.arange(case.frame_len, device=device) \
            < case.frame_len - case.n_invalid
        return frame.repeat(case.n // case.frame_len)
    return torch.arange(case.n, device=device) < case.n - case.n_invalid


def _ref_by_heads(fa, q, k, v, kv, heads_per_call: int):
    import torch

    outs, lses = [], []
    for h0 in range(0, q.shape[2], heads_per_call):
        sl = slice(h0, h0 + heads_per_call)
        o, lse = fa.flash_attention_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                        kv)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=1)


def o_excess(o, o_ref) -> float:
    """max |ΔO| / (O_ATOL_STD·std(O_ref) + O_RTOL·|O_ref|) over the
    elements: a correct kernel stays at or below 1."""
    import torch

    ref = o_ref.float()
    limit = O_ATOL_STD * ref.std() + O_RTOL * ref.abs() \
        + torch.finfo(torch.float32).tiny
    return ((o.float() - ref).abs() / limit).max().item()


def compare_case(fa, case: Case, gen):
    """One kernel call on bf16 inputs drawn from `gen`, held against the
    plain version → (result, passed, inputs (q, k, v, key_valid))."""
    import torch

    dev = torch.device("cuda")
    shape = (case.b, case.n, case.h, case.d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kv = _key_valid(case, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, kv)
    torch.cuda.synchronize()
    heads_per_call = 2 if case.n > 8192 else case.h
    o_ref, lse_ref = _ref_by_heads(fa, q, k, v, kv, heads_per_call)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    excess = o_excess(o, o_ref)
    res = {"case": case.name, "shape": list(shape), "masked": kv is not None,
           "natural": case.natural, "max_abs_err_o": err_o,
           "o_excess": excess, "max_abs_err_lse": err_lse}
    return res, excess <= 1.0 and err_lse <= LSE_ATOL, (q, k, v, kv)


def check_case(fa, case: Case, gen, *, timed: bool) -> dict:
    import torch.nn.functional as F

    res, passed, (q, k, v, kv) = compare_case(fa, case, gen)
    check(passed, f"kernel disagrees with flash_attention_ref: {res} "
          f"(LSE atol {LSE_ATOL})")
    if not timed:
        log(f"kernels: {json.dumps(res)}")
        return res

    n_live = case.n if kv is None else int(kv.sum().item())
    flops = 4.0 * case.b * case.n * n_live * case.h * case.d
    n_bytes = 4 * q.numel() * 2 + case.b * case.h * case.n * 4 \
        + (0 if kv is None else kv.numel())
    bound_flops = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes = n_bytes / PEAK_BYTES * 1e3
    heads_per_call = 2 if case.n > 8192 else case.h
    kernel_ms = cuda_events_ms(lambda: fa.flash_attention_fwd(q, k, v, kv),
                               iters=20)
    plain_ms = cuda_events_ms(
        lambda: _ref_by_heads(fa, q, k, v, kv, heads_per_call), iters=3,
        warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None if kv is None else kv[None, None, None, :]
    library_ms = cuda_events_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        iters=10)
    res.update(flops=flops, bytes=n_bytes, kernel_ms=kernel_ms,
               bound_ms=max(bound_flops, bound_bytes),
               bound_by="operations" if bound_flops >= bound_bytes
               else "bytes",
               plain_ms=plain_ms, library_ms=library_ms,
               tflops=flops / kernel_ms / 1e9)
    log(f"kernels: {json.dumps(res)}")
    return res


def phase_kernels() -> dict:
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {
        "vit": check_case(fa, Case("vit", 13, 1029, 16, 64, 0), gen,
                          timed=True),
        "frame": check_case(fa, Case("frame", 13, 1040, 16, 64, 11), gen,
                            timed=True),
        "global": check_case(fa, Case("global", 1, 13520, 16, 64, 11,
                                      frame_len=1040), gen, timed=True),
        # the VDM step's global attention, unmasked (48 launches a step)
        "global_unmasked": check_case(
            fa, Case("global_unmasked", 1, 13377, 16, 64, 0), gen,
            timed=True),
        # CogVideoX-5B's joint attention: 226 text + 17,550 video tokens,
        # the CFG pair, 48 heads of 64 (42 launches a DiT forward)
        "cogvideox": check_case(fa, Case("cogvideox", 2, 17776, 48, 64, 0),
                                gen, timed=True),
        # Wan DiT self-attention at 512² (4096 tokens), the CFG pair
        "dit_1_3b": check_case(fa, Case("dit_1_3b", 2, 4096, 12, 128, 0), gen,
                               timed=True),
        "dit_14b": check_case(fa, Case("dit_14b", 2, 4096, 40, 128, 0), gen,
                              timed=True),
    }
    check_case(fa, Case("natural_ragged", 2, 1100, 2, 128, 0), gen,
               timed=False)
    check_case(fa, Case("natural_short", 1, 45, 3, 128, 0), gen, timed=False)
    # the wgmma kernel at head_dim 64: N no multiple of the tiles, N below
    # one tile
    check_case(fa, Case("ragged_d64", 2, 1100, 2, 64, 0), gen, timed=False)
    check_case(fa, Case("short_d64", 1, 45, 3, 64, 0), gen, timed=False)
    # every key masked: O = 0, LSE = the finite sentinel −1e30·ln 2
    check_case(fa, Case("all_masked", 2, 130, 4, 64, 130), gen, timed=False)
    check_case(fa, Case("ragged_d128", 2, 333, 3, 128, 7), gen, timed=False)
    # the mma.sync kernel on the head dims it still serves, over one and
    # over several key tiles of 64
    check_case(fa, Case("ragged_d40", 1, 77, 2, 40, 0), gen, timed=False)
    check_case(fa, Case("mma_d40", 2, 1100, 2, 40, 0), gen, timed=False)
    check_case(fa, Case("mma_d96", 2, 1100, 2, 96, 7), gen, timed=False)
    # strided inputs, read in place: q, k, v as views into one qkv tensor,
    # at head_dim 64 and 128 (the wgmma kernels, forward and backward)
    for d in (64, 128):
        check_strided(fa, d, gen)
    # the training step's fp32 attention: forward and backward (kernel 4)
    for name, shape in F32_CASES:
        timed[name] = check_f32_case(fa, name, shape, gen,
                                     timed=name in F32_TIMED)
    # the VDM step's bf16 backward (kernels 4b and 5)
    for name, shape in BF16_BWD_CASES:
        timed[name] = check_bf16_bwd_case(fa, name, shape, gen,
                                          timed=name in BF16_BWD_TIMED)
    # the DiT's q/k prologue, and its launches a 14B and a 1.3B forward
    for case in QK_CASES:
        timed[case[0]] = check_qk_case(case, gen, timed=True)
    timed["qk_launches"] = check_qk_launches()
    timed["cogvideox_launches"] = check_cogvideox_launches()
    return timed


def qk_ulps(got, ref, roped: bool):
    """|got − ref| in bf16 ulps at each element's magnitude: max(|got|,
    |ref|), or after RoPE the norm of its (even, odd) pair, widened by 2⁻⁷
    to cover the outputs' own rounding."""
    import torch

    g, r = got.float(), ref.float()
    if roped:
        pairs = r.reshape(*r.shape[:-1], -1, 2)
        mag = pairs.square().sum(-1).sqrt().repeat_interleave(2, dim=-1) \
            * (1 + 2 ** -7)
    else:
        mag = torch.maximum(g.abs(), r.abs())
    _, exp = torch.frexp(mag.clamp_min(torch.finfo(torch.float32).tiny))
    return (g - r).abs() / torch.ldexp(torch.ones_like(mag), exp - 8)


def compare_qk_prologue(case: tuple, gen):
    """One q/k prologue launch on inputs drawn from `gen`, held against
    the plain version on the card → (result, passed, (inputs, the kernel's
    outputs))."""
    import torch

    from vist3a_tpu_torch.kernels import qk_prologue as qkp
    from vist3a_tpu_torch.nn import wan_dit

    name, b, n, d, heads, parts, roped = case
    bf16, dev = torch.bfloat16, torch.device("cuda")
    x = torch.randn(b, n, parts * d, generator=gen, device=dev).to(bf16)
    biases = tuple((0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
                   for _ in range(parts))
    scales = tuple((1 + 0.1 * torch.randn(d, generator=gen, device=dev))
                   .to(bf16) for _ in range(min(parts, 2)))
    rope = None
    if roped:
        cfg = wan_dit.WanDiTConfig(dim=d, num_heads=heads)
        grid = QK_GRID if n == 4096 else (1, 1, n)
        rope = tuple(t.to(dev) for t in wan_dit.rope_tables(cfg, *grid))
    args = (x, biases, scales, 1e-6, d // heads, rope)
    before = qkp.launches
    outs = qkp.qk_prologue(*args)
    torch.cuda.synchronize()
    launched = qkp.launches - before
    refs = qkp.qk_prologue_ref(*args)
    # the normed parts before RoPE: the kernel without tables
    pre, pre_ref = (qkp.qk_prologue(*args[:5]), qkp.qk_prologue_ref(
        *args[:5])) if roped else (outs, refs)
    res = {"case": name, "shape": [b, n, d], "heads": heads, "parts": parts,
           "rope": roped, "launches": launched, "max_ulps": [],
           "differ_share": [], "rotated_ulps": [], "rope_exact": []}
    passed = launched == 1
    for i, (o, r) in enumerate(zip(outs, refs)):
        passed = passed and o.shape == r.shape and o.is_contiguous()
        res["differ_share"].append((o != r).float().mean().item())
        if i >= len(scales):
            passed = passed and res["differ_share"][-1] == 0.0
            continue
        res["max_ulps"].append(qk_ulps(pre[i], pre_ref[i], False).max()
                               .item())
        passed = passed and res["max_ulps"][-1] <= QK_MAX_ULPS
        if roped:
            res["rotated_ulps"].append(qk_ulps(o, r, True).max().item())
            res["rope_exact"].append(bool(torch.equal(
                o, wan_dit.apply_rope(pre[i], *rope))))
            passed = passed and res["rope_exact"][-1]
    return res, passed, (args, outs)


def queued_events_ms(fn, iters: int) -> float:
    """`cuda_events_ms` with the card held busy (`torch.cuda._sleep`) while
    the host queues the launches, so that a call whose host side outlasts
    its kernel (the q/k prologue's small shapes) is timed on the card."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)         # ~50 ms at the card's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_qk_case(case: tuple, gen, *, timed: bool) -> dict:
    """`compare_qk_prologue`, then the kernel and the plain version timed
    on the card (`queued_events_ms`) beside the bound: every byte read once
    (the product, biases, scales, tables) and written once, at 3.35 TB/s;
    `wrapper_ms` is the kernel's call timed as `cuda_events_ms` times the
    other kernels, the host's side included where it is the longer."""
    from vist3a_tpu_torch.kernels import qk_prologue as qkp

    res, passed, (args, outs) = compare_qk_prologue(case, gen)
    check(passed, f"q/k prologue disagrees with its plain version: {res}")
    if timed:
        x, biases, scales, _, _, rope = args
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (x, *biases, *scales, *(rope or ()), *outs))
        res.update(bytes=n_bytes,
                   kernel_ms=queued_events_ms(
                       lambda: qkp.qk_prologue(*args), iters=20),
                   wrapper_ms=cuda_events_ms(
                       lambda: qkp.qk_prologue(*args), iters=20),
                   plain_ms=queued_events_ms(
                       lambda: qkp.qk_prologue_ref(*args), iters=5),
                   bound_ms=n_bytes / PEAK_BYTES * 1e3, bound_by="bytes")
        res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    log(f"kernels: {json.dumps(res)}")
    return res


def check_qk_launches() -> dict:
    """The q/k prologue's launches over one DiT forward at 512², 13 frames
    (4,096 latent and 226 text tokens, the CFG pair) of the 14B and of the
    1.3B DiT, weights drawn on the card: 3 a block (self q/k/v, cross q,
    cross k) in inference, none in the training entry with grad enabled
    (`remat=True`, the plain version's torch ops).  The two forwards'
    outputs differ where q and k do, by up to a bf16 step: the VDM rollout
    takes its value from the first and its gradient through the second,
    so their relative difference (max and norm) is logged.  The 14B
    inference forward runs again under the profiler (`profile_call`): the
    prologue's device time a forward, one CFG step, beside the glue's."""
    import torch

    from vist3a_tpu_torch.nn import wan_dit

    res = {}
    for name, cfg in (("14b", wan_dit.WAN_14B), ("1_3b", wan_dit.WAN_1_3B)):
        gen = torch.Generator(device="cuda").manual_seed(7)
        dit = wan_dit.init(cfg, gen, "cuda", torch.bfloat16)
        latent = torch.randn(2, 16, 4, 64, 64, generator=gen,
                             device="cuda").to(torch.bfloat16)
        text = torch.randn(2, 226, cfg.text_dim, generator=gen,
                           device="cuda").to(torch.bfloat16)
        ts = torch.tensor([999.0, 999.0], device="cuda")
        _reset_counts()
        out = wan_dit.forward(dit, latent, ts, text)
        torch.cuda.synchronize()
        inference = _vdm_counts()["qk_prologue"]
        with torch.enable_grad():
            ref = wan_dit.forward(dit, latent, ts, text, remat=True).detach()
        torch.cuda.synchronize()
        grad = _vdm_counts()["qk_prologue"] - inference
        o, r = out.float(), ref.float()
        res[name] = {"inference": inference, "grad": grad,
                     "want": 3 * cfg.num_layers,
                     "max_rel_vs_grad_path":
                         ((o - r).abs().max() / r.abs().max()).item(),
                     "norm_rel_vs_grad_path":
                         ((o - r).norm() / r.norm()).item()}
        check(bool(torch.isfinite(out).all()),
              f"q/k prologue: the {name} DiT's output is not finite")
        if name == "14b":
            profile_call("qk_14b_forward",
                         lambda: wan_dit.forward(dit, latent, ts, text))
        del dit, out, ref, o, r
        torch.cuda.empty_cache()
    log(f"kernels: q/k prologue launches a DiT forward {json.dumps(res)}")
    check(all(r["inference"] == r["want"] and r["grad"] == 0
              for r in res.values()),
          f"q/k prologue launches a forward {res}")
    return res


def check_cogvideox_launches(steps: int = 2) -> dict:
    """A short CogVideoX-5B denoise at the published 480×720, 49 frames
    (`pipelines/t23d.py::denoise` with a `T2VConfig` of `steps` DDIM
    steps, the CFG pair; DiT weights drawn on the card, random text
    embeddings): its joint attention is one head_dim-64 flash launch a
    block, 42 a forward, counted in `launches_unmasked`, and no other
    flash entry runs."""
    import dataclasses

    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.nn import cogvideox_dit
    from vist3a_tpu_torch.pipelines import t23d

    cfg = dataclasses.replace(t23d.T2VConfig(), num_inference_steps=steps)
    gen = torch.Generator(device="cuda").manual_seed(11)
    dit = cogvideox_dit.init(cfg.dit, gen, "cuda", torch.bfloat16)
    cond, uncond = (torch.randn(1, cfg.t5.max_sequence_length,
                                cfg.dit.text_embed_dim, generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    _reset_counts()
    t0 = time.perf_counter()
    lat = t23d.denoise(dit, cond, uncond, cfg, device="cuda")
    torch.cuda.synchronize()
    res = {"steps": steps, "seconds": time.perf_counter() - t0,
           "unmasked": fa.launches_unmasked, "natural": fa.launches_natural,
           "masked": fa.launches_masked,
           "want_a_forward": cfg.dit.num_layers,
           "finite": bool(torch.isfinite(lat).all())}
    del dit
    torch.cuda.empty_cache()
    log(f"kernels: CogVideoX denoise launches {json.dumps(res)}")
    check(res["finite"] and res["unmasked"] == steps * cfg.dit.num_layers
          and res["natural"] == res["masked"] == 0,
          f"CogVideoX launches {res}")
    return res


def check_strided(fa, d: int, gen) -> None:
    """q, k, v as views into one (2, 1100, 3, 4, d) bf16 tensor, read in
    place: O and LSE within the limits of the other cases, and the
    backward, each gradient within the `grad_excess` limit and the same
    bits twice."""
    import torch

    qkv = torch.randn(2, 1100, 3, 4, d, generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    res = {"case": f"strided_d{d}",
           "max_abs_err_o": (o.float() - o_ref.float()).abs().max().item(),
           "o_excess": o_excess(o, o_ref),
           "max_abs_err_lse": (lse - lse_ref).abs().max().item()}
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    ref = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for x, g, r in zip("qkv", got, ref):
        res[f"excess_d{x}"] = grad_excess(g, r)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    res["bitwise_repeatable"] = all(torch.equal(x, y)
                                    for x, y in zip(got, again))
    passed = (res["o_excess"] <= 1.0 and res["max_abs_err_lse"] <= LSE_ATOL
              and res["bitwise_repeatable"]
              and max(res[f"excess_d{x}"] for x in "qkv") <= 1.0)
    check(passed, f"strided inputs: {res}")
    log(f"kernels: strided qkv views {json.dumps(res)}")


def grad_excess(g, ref) -> float:
    """max |Δ| / (GRAD_ATOL_STD·std(ref) + GRAD_RTOL·|ref|) over the
    elements: a correct kernel stays at or below 1."""
    import torch

    ref = ref.float()
    limit = GRAD_ATOL_STD * ref.std() + GRAD_RTOL * ref.abs() \
        + torch.finfo(torch.float32).tiny
    return ((g.float() - ref).abs() / limit).max().item()


def _bwd_ref_by_heads(fa, q, k, v, o, lse, do, heads_per_call: int):
    """The plain backward a few heads at a time (the global case's fp32
    score matrices are 0.7 GB a head)."""
    import torch

    outs = [fa.flash_attention_bwd_ref(
        q[:, :, sl], k[:, :, sl], v[:, :, sl], o[:, :, sl], lse[:, sl],
        do[:, :, sl])
        for sl in (slice(h0, h0 + heads_per_call)
                   for h0 in range(0, q.shape[2], heads_per_call))]
    return [torch.cat([x[i] for x in outs], dim=2) for i in range(3)]


def compare_bf16_bwd_case(fa, name: str, shape: tuple, gen):
    """The bf16 backward kernel (its forward first) against the plain
    version on bf16 inputs drawn from `gen`: each gradient within the
    `grad_excess` limit, the same bits twice → (result, passed,
    inputs and forward outputs)."""
    import torch

    n, h = shape[1], shape[2]
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    ref = _bwd_ref_by_heads(fa, q, k, v, o, lse, do, 2 if n > 8192 else h)
    res = {"case": name, "shape": list(shape)}
    for x, g, r in zip("qkv", got, ref):
        res[f"excess_d{x}"] = grad_excess(g, r)
        res[f"max_abs_err_d{x}"] = (g.float() - r.float()).abs().max().item()
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    res["bitwise_repeatable"] = all(torch.equal(x, y)
                                    for x, y in zip(got, again))
    passed = (max(res[f"excess_d{x}"] for x in "qkv") <= 1.0
              and res["bitwise_repeatable"])
    return res, passed, (q, k, v, do, o, lse)


def check_bf16_bwd_case(fa, name: str, shape: tuple, gen, *,
                        timed: bool) -> dict:
    """`compare_bf16_bwd_case`, failing the run on a disagreement; with
    `timed`, the kernels' time beside the plain version's, SDPA's bf16
    backward (its forward and backward under autograd, less its forward)
    and the bound."""
    import torch
    import torch.nn.functional as F

    b, n, h, d = shape
    res, passed, (q, k, v, do, o, lse) = compare_bf16_bwd_case(
        fa, name, shape, gen)
    check(passed, f"bf16 flash backward disagrees with its plain version: "
          f"{res} (limit {GRAD_ATOL_STD}·std + {GRAD_RTOL}·|ref|)")
    if not timed:
        log(f"kernels: bf16 backward {json.dumps(res)}")
        return res
    flops = 10.0 * b * n * n * h * d
    elems = b * n * h * d
    n_bytes = 2 * 8 * elems + 4 * 2 * b * h * n   # q k v O dO in, 3 out; LSE, δ
    bwd_ms = cuda_events_ms(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), iters=5,
        warmup=1)
    plain_ms = cuda_events_ms(
        lambda: _bwd_ref_by_heads(fa, q, k, v, o, lse, do,
                                  2 if n > 8192 else h), iters=1, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt)

    with torch.no_grad():
        lib_fwd = cuda_events_ms(sdpa, iters=5, warmup=1)
    lib_both = cuda_events_ms(lambda: sdpa().backward(dot), iters=5,
                              warmup=1)
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    res.update(flops=flops, bytes=n_bytes, bwd_ms=bwd_ms, plain_ms=plain_ms,
               library_ms=lib_both - lib_fwd, library_fwd_ms=lib_fwd,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               tflops=flops / bwd_ms / 1e9)
    log(f"kernels: bf16 backward {json.dumps(res)}")
    return res


def _f32_ref_by_heads(fa, q, k, v, do, heads_per_call: int):
    """The plain forward and backward, a few heads at a time (the global
    case's fp32 score matrices are 1.9 GB a head)."""
    import torch

    outs = []
    for h0 in range(0, q.shape[2], heads_per_call):
        sl = slice(h0, h0 + heads_per_call)
        o, lse = fa.flash_attention_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl])
        outs.append((o, lse, *fa.flash_attention_bwd_ref(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], o, lse, do[:, :, sl])))
    o, lse, dq, dk, dv = (torch.cat([x[i] for x in outs],
                                    dim=1 if i == 1 else 2)
                          for i in range(5))
    return o, lse, dq, dk, dv


def library_fwd_bwd_ms(q, k, v, do) -> tuple[float, float, str]:
    """`F.scaled_dot_product_attention` on the same fp32 inputs, restricted
    to the memory-efficient backend (the one that takes fp32; the math
    backend would hold (B, H, N, N)) → (its forward ms, its forward plus
    backward under autograd minus its forward, the kernels it ran) — a
    yardstick the port never calls."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    def fwd_bwd():
        fwd().backward(dot)

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fwd_bwd()
            torch.cuda.synchronize()
        names = sorted({ev.name[:60] for ev in prof.events()
                        if ev.device_type == torch.autograd.DeviceType.CUDA
                        and any(s in ev.name.lower()
                                for s in ("fmha", "attention", "mem_eff"))})
        with torch.no_grad():
            fwd_ms = cuda_events_ms(fwd, iters=3, warmup=1)
        both_ms = cuda_events_ms(fwd_bwd, iters=3, warmup=1)
    return fwd_ms, both_ms - fwd_ms, "efficient: " + ", ".join(names)


def compare_f32_case(fa, name: str, shape: tuple, gen):
    """The fp32 forward and the backward kernel against their plain
    versions on fp32 inputs drawn from `gen`: O within F32_O_RTOL of its
    largest magnitude, each gradient within F32_GRAD_RTOL of its, LSE
    within F32_LSE_ATOL, the backward the same bits twice → (result,
    passed, inputs and outputs)."""
    import torch

    n, h = shape[1], shape[2]
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    ref = _f32_ref_by_heads(fa, q, k, v, do, 2 if n > 8192 else h)

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max()).item()
    res = {"case": name, "shape": list(shape),
           "rel_err_o": rel(o, ref[0]),
           "max_abs_err_lse": (lse - ref[1]).abs().max().item(),
           "rel_err_dq": rel(dq, ref[2]), "rel_err_dk": rel(dk, ref[3]),
           "rel_err_dv": rel(dv, ref[4]),
           "max_abs_err_o": (o - ref[0]).abs().max().item(),
           "max_abs_err_grads": max((x - y).abs().max().item() for x, y in
                                    zip((dq, dk, dv), ref[2:]))}
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    res["bitwise_repeatable"] = all(torch.equal(x, y)
                                    for x, y in zip((dq, dk, dv), again))
    passed = (res["rel_err_o"] <= F32_O_RTOL
              and res["max_abs_err_lse"] <= F32_LSE_ATOL
              and max(res[f"rel_err_d{x}"] for x in "qkv") <= F32_GRAD_RTOL
              and res["bitwise_repeatable"])
    return res, passed, (q, k, v, do, o, lse)


def check_f32_case(fa, name: str, shape: tuple, gen, *, timed: bool) -> dict:
    """`compare_f32_case`, failing the run on a disagreement; with `timed`,
    both kernels' times beside the plain versions', SDPA's and the
    bounds."""
    b, n, h, d = shape
    res, passed, (q, k, v, do, o, lse) = compare_f32_case(fa, name, shape,
                                                          gen)
    check(passed, f"fp32 flash kernels disagree with their plain versions: "
          f"{res}")
    heads_per_call = 2 if n > 8192 else h
    if not timed:
        log(f"kernels: fp32 {json.dumps(res)}")
        return res
    fwd_flops = 4.0 * b * n * n * h * d
    bwd_flops = 10.0 * b * n * n * h * d
    elems = b * n * h * d
    fwd_bytes = 4 * (4 * elems + b * h * n)
    bwd_bytes = 4 * (8 * elems + b * h * n)   # q k v O dO and LSE in, 3 out
    fwd_ms = cuda_events_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=5,
                            warmup=1)
    bwd_ms = cuda_events_ms(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), iters=3,
        warmup=1)
    plain_ms = cuda_events_ms(
        lambda: _f32_ref_by_heads(fa, q, k, v, do, heads_per_call), iters=1,
        warmup=1)
    library_fwd_ms, library_ms, backend = library_fwd_bwd_ms(q, k, v, do)

    # the bound of the instructions the kernels run (three TF32 products
    # for each fp32-accurate one), and, beside it, the CUDA cores' FFMA one
    def bound(flops, n_bytes, peak=PEAK_3XTF32_FLOPS):
        ops_ms = flops / peak * 1e3
        bytes_ms = n_bytes / PEAK_BYTES * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")
    fwd_bound, fwd_by = bound(fwd_flops, fwd_bytes)
    bwd_bound, bwd_by = bound(bwd_flops, bwd_bytes)
    res.update(fwd_flops=fwd_flops, bwd_flops=bwd_flops, fwd_ms=fwd_ms,
               bwd_ms=bwd_ms, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
               bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by,
               fwd_bound_ffma_ms=bound(fwd_flops, fwd_bytes,
                                       PEAK_FP32_FLOPS)[0],
               bwd_bound_ffma_ms=bound(bwd_flops, bwd_bytes,
                                       PEAK_FP32_FLOPS)[0],
               plain_fwd_bwd_ms=plain_ms, library_fwd_ms=library_fwd_ms,
               library_bwd_ms=library_ms, library_backend=backend,
               fwd_tflops=fwd_flops / fwd_ms / 1e9,
               bwd_tflops=bwd_flops / bwd_ms / 1e9,
               fwd_vs_library=fwd_ms / library_fwd_ms,
               bwd_vs_library=bwd_ms / library_ms)
    log(f"kernels: fp32 {json.dumps(res)}")
    return res


def stitched_config():
    from vist3a_tpu_torch.nn.encoder import EncoderConfig
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    return ca.StitchedConfig(encoder=EncoderConfig(head_dtype="bfloat16"))


def _check_output(out, n_gauss: int) -> None:
    import torch

    g = out.gaussians
    for t, shape in ((g.means, (1, n_gauss, 3)),
                     (g.covariances, (1, n_gauss, 3, 3)),
                     (g.harmonics, (1, n_gauss, 3, 25)),
                     (g.opacities, (1, n_gauss))):
        check(tuple(t.shape) == shape, f"shape {tuple(t.shape)}, want {shape}")
    for name, t in (*g._asdict().items(), ("depth", out.depth),
                    ("depth_conf", out.depth_conf),
                    ("extrinsic_c2w", out.extrinsic_c2w),
                    ("intrinsic_norm", out.intrinsic_norm)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")


def build_stitched():
    import torch

    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = ca.init(stitched_config(), gen, device="cuda",
                    dtype=torch.bfloat16)
    # Random weights give each of the 13 frames an unrelated camera: a
    # context view then sees only its own frame's Gaussians (~1/13) and an
    # in-between orbit view none.  With the pose branch's last weight scaled
    # down, every frame's camera lies near the bias pose (see CAMERA_BIAS)
    # and still follows its own frame, so the orbit moves through cameras
    # that see one scene, as a trained model's consistent cameras do.
    fc2 = model.encoder.camera_head.pose_branch.fc2
    fc2.weight.mul_(CAMERA_WEIGHT_SCALE)
    fc2.bias.copy_(torch.tensor(CAMERA_BIAS))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: StitchedConfig() full width, {n_params} parameters, built "
        f"in {time.perf_counter() - t0:.1f} s")
    return model


def phase_slice(model, profile: bool) -> dict:
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    cfg = stitched_config()
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = []
    for _ in range(REQUESTS):
        latent = torch.randn(1, 16, 4, 64, 64, generator=gen, device="cuda"
                             ).to(torch.bfloat16)
        images = (torch.rand(1, 3, 13, 448, 448, generator=gen, device="cuda")
                  * 2 - 1).to(torch.bfloat16)
        inputs.append((latent, images))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    latencies = []
    fa.reset_launch_counts()
    for i, (latent, images) in enumerate(inputs):
        before = (fa.launches_unmasked, fa.launches_masked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ca.forward_with_latent(model, latent, images, cfg)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        grew = (fa.launches_unmasked - before[0],
                fa.launches_masked - before[1])
        _check_output(out, GAUSSIANS)
        expect = (LAUNCHES_PER_REQUEST["unmasked"],
                  LAUNCHES_PER_REQUEST["masked"])
        check(grew == expect, f"request {i}: launches {grew}, want {expect}")
        log(f"slice: request {i}: {latencies[-1]:.1f} ms, launches unmasked "
            f"+{grew[0]} masked +{grew[1]}, G={out.gaussians.means.shape[1]}, "
            f"scene_scale {out.scene_scale.item():.6g}")
        del out
    counts = {"unmasked": fa.launches_unmasked, "masked": fa.launches_masked}
    peak = torch.cuda.max_memory_allocated()
    log(f"slice: latency ms {latencies}; peak memory allocated {peak} B; "
        f"launches {counts}")
    if profile:
        latent, images = inputs[-1]
        profile_call("slice", lambda: ca.forward_with_latent(
            model, latent, images, cfg))
        stage_times(model, cfg, latent, images)
    return {"latency_ms": latencies, "peak_bytes": peak, "launches": counts}


def _kernel_group(name: str) -> str:
    low = name.lower()
    d64 = any(t in low for t in ("kernel<64", "kernelili64"))
    if "flash_fwd_f32_sm90_kernel" in low:
        return "flash attention forward, fp32 3×TF32 wgmma (this repo)"
    if "flash_bwd_dkv_f32_sm90_kernel" in low \
            or "flash_bwd_dq_f32_sm90_kernel" in low:
        return "flash attention backward, fp32 3×TF32 wgmma (this repo)"
    if "tf32_split_planes" in low:
        return "flash attention fp32 split planes (this repo)"
    if "flash_fwd_sm90_kernel" in low:
        return ("flash attention, bf16 D = 64, wgmma (this repo)" if d64
                else "flash attention, natural D = 128, wgmma (this repo)")
    if "flash_bwd_dkv_sm90_kernel" in low or "flash_bwd_dq_sm90_kernel" in low:
        return ("flash attention backward, bf16 D = 64, wgmma (this repo)"
                if d64 else
                "flash attention backward, natural D = 128, wgmma (this repo)")
    if "flash_fwd_kernel<128>" in low or "flash_fwd_kernelili128" in low:
        return "flash attention, natural D = 128 (this repo)"
    if "flash_bwd_dkv_bf16_kernel<128>" in low \
            or "flash_bwd_dq_bf16_kernel<128>" in low:
        return "flash attention backward, bf16 D = 128 (this repo)"
    if "bf16_kernel" in low and "flash_bwd_" in low:
        return "flash attention backward, bf16 D = 64 (this repo)"
    if "flash_fwd_kernel" in low:
        return "flash attention (this repo)"
    if any(t in low for t in ("conv", "cudnn", "implicit_convolve", "wgrad",
                              "dgrad", "fprop")):
        return "convolution (cuDNN)"
    if "memcpy" in low:
        return "host-to-device copies"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "sm90_", "gemv",
                              "nvjet")):
        return "matmul (cuBLAS)"
    if "composite_fwd_kernel" in low:
        return "rasterizer composite (this repo)"
    if "composite_bwd_kernel" in low:
        return "rasterizer composite backward (this repo)"
    if "qk_prologue_kernel" in low:
        return "q/k prologue (this repo)"
    if any(t in low for t in ("sort", "radix", "quantile", "topk")):
        return "sort / quantile"
    if "layer_norm" in low or "layernorm" in low:
        return "layer norm"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled",
                              "reduce", "cat", "copy", "index", "fill")):
        return "elementwise / copy / reduce"
    return "other"


def profile_call(label: str, fn, stages=(), nested=()) -> None:
    """`fn()` under torch.profiler: device time by kernel and group, the
    device's busy share of its wall time, and for each of the profiler
    ranges `stages` (which follow one another) and `nested` (inside them)
    its calls, host time and the device time of the kernels it launched.
    The port's own kernels launch through ctypes, outside any aten op, so
    the profiler ties them to no range: their device time is in the group
    lines only (flash attention in `decode.stitched`, the composite in
    `render.composite`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    kernels = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.is_user_annotation:
            continue
        us = ev.time_range.elapsed_us()
        kernels[ev.name] = kernels.get(ev.name, 0.0) + us / 1e3
    device_ms = sum(kernels.values())
    if device_ms == 0:
        raise RuntimeError("torch.profiler recorded no device time")
    groups = {}
    for name, ms in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    tag = f"profile[{label}]"
    log(f"{tag}: request wall {wall_ms:.3f} ms (under the profiler), "
        f"device kernels {device_ms:.3f} ms, busy share "
        f"{device_ms / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"{tag}: group {g}: {ms:.3f} ms ({ms / device_ms:.4f})")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    for name, ms in top[:12]:
        log(f"{tag}: kernel {ms:9.3f} ms  {name[:110]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for ev in host[:12]:
        log(f"{tag}: host op {ev.self_cpu_time_total / 1e3:9.3f} ms self, "
            f"{ev.count:5d} calls  {ev.key[:90]}")
    if stages:
        ranges = {n: [0, 0.0, 0.0] for n in (*stages, *nested)}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CPU \
                    and ev.name in ranges:
                r = ranges[ev.name]
                r[0] += 1
                r[1] += ev.time_range.elapsed_us() / 1e3
                r[2] += ev.device_time_total / 1e3
        missing = [n for n, r in ranges.items() if r[0] == 0]
        check(not missing, f"{tag}: no profiler range {missing}")
        for n, (calls, host_ms, dev_ms) in ranges.items():
            log(f"{tag}: range {n}: {calls} calls, host {host_ms:.3f} ms, "
                f"device {dev_ms:.3f} ms")
        host_sum = sum(ranges[n][1] for n in stages)
        log(f"{tag}: the {len(stages)} stages' host time {host_sum:.3f} ms of "
            f"the request's {wall_ms:.3f} ms ({wall_ms - host_sum:.3f} ms "
            f"outside them)")
    log(f"{tag}: the profile's own processing (events, averages) "
        f"{time.perf_counter() - t1:.1f} s")


def stage_times(model, cfg, latent, images) -> None:
    """Host clock, synchronised, around each stage of one request (the
    stages of `stitched_forward`), then each head on its own."""
    import torch

    from vist3a_tpu_torch.nn import aggregator as agg_mod
    from vist3a_tpu_torch.nn import heads as heads_mod
    from vist3a_tpu_torch.nn.encoder import heads_pipeline
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    stages = {}
    enc, ecfg = model.encoder, cfg.encoder

    def mark(name, t0):
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok = model.stitch_conv(ca.pre_upsample(latent, cfg))
        t = mark("pre_upsample + stitch conv", t)
        b, d, s, gh, gw = tok.shape
        flat = tok.permute(0, 2, 3, 4, 1).reshape(b * s, gh * gw, d)
        patch = ca.chopped_vit_forward(enc.vit, flat, (gh, gw), cfg)
        t = mark("chopped ViT (8 blocks)", t)
        cam = agg_mod.expand_special_tokens(
            enc.aggregator.camera_token.to(patch.dtype), b, s)
        reg = agg_mod.expand_special_tokens(
            enc.aggregator.register_token.to(patch.dtype), b, s)
        tokens = torch.cat([cam, reg, patch], dim=1).reshape(b, s, -1, d)
        _, taps = agg_mod.run_trunk(enc.aggregator, tokens, ecfg.agg, (gh, gw))
        t = mark("aggregator trunk (24 pairs)", t)
        images01 = (images.transpose(1, 2) + 1.0) / 2.0
        heads_pipeline(enc, ecfg, taps, images01)
        t = mark("heads_pipeline (all heads + assembly)", t)
        heads_mod.camera_head_apply(enc.camera_head, taps[-1], ecfg.camera)
        t = mark("  of which camera head", t)
        hdt = torch.bfloat16 if ecfg.head_dtype == "bfloat16" else \
            torch.float32
        taps_h = [x.to(hdt) for x in taps]
        psi = ecfg.agg.patch_start_idx
        heads_mod.dpt_apply(enc.depth_head, taps_h, images.shape[-2:], psi,
                            ecfg.depth, (b, s))
        t = mark("  of which depth DPT", t)
        heads_mod.gs_head_apply(enc.gs_head, taps_h, images01.to(hdt), psi,
                                ecfg.gs)
        mark("  of which GS DPT", t)
    for name, ms in stages.items():
        log(f"stages: {name}: {ms:.3f} ms")


def narrow_config(pred_head_type: str = "depth"):
    from vist3a_tpu_torch.nn.aggregator import AggregatorConfig
    from vist3a_tpu_torch.nn.encoder import EncoderConfig
    from vist3a_tpu_torch.nn.heads import (CameraHeadConfig, DPTConfig,
                                           GSHeadConfig)
    from vist3a_tpu_torch.nn.vit import ViTConfig
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    d = 128
    ecfg = EncoderConfig(
        vit=ViTConfig(embed_dim=d, depth=3, num_heads=2),
        agg=AggregatorConfig(embed_dim=d, depth=4, num_heads=2,
                             taps=(0, 1, 2, 3)),
        camera=CameraHeadConfig(dim_in=2 * d, trunk_depth=1, num_heads=2),
        depth=DPTConfig(dim_in=2 * d, features=16,
                        out_channels=(8, 16, 16, 16), head2_features=8),
        point=DPTConfig(dim_in=2 * d, features=16,
                        out_channels=(8, 16, 16, 16), head2_features=8,
                        activation="inv_log", output_dim=4),
        gs=GSHeadConfig(dim_in=2 * d, features=16,
                        out_channels=(8, 16, 16, 16), output_dim=84,
                        head2_features=16, pos_embed=False),
        pred_head_type=pred_head_type)
    return ca.StitchedConfig(encoder=ecfg, stitch_layer_index=2,
                             conv_spec=f"conv3d_k5x3x3_o{d}_s1x2x2_p2x1x1")


def phase_reference() -> dict:
    """Narrow widths at the full spatial shape (5 frames of 448², P = 1029):
    the card runs the kernel (ViT N = 1029, frame 1040, global 5200), the
    host CPU the plain attention, on the same bf16 weights and inputs."""
    return {**narrow_decoder_errors(narrow_config(), "reference"),
            **reference_dit()}


def narrow_decoder_errors(cfg, label: str) -> dict:
    """A narrow stitched decoder of config `cfg` on the card and on the host
    CPU, the same bf16 weights and inputs: each output's max |Δ| / max
    |ref|, within 2⁻⁵."""
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    gen = torch.Generator().manual_seed(1)
    model = ca.init(cfg, gen, device="cpu", dtype=torch.bfloat16)
    model.encoder.camera_head.pose_branch.fc2.bias.copy_(
        torch.tensor(CAMERA_BIAS))
    latent = torch.randn(1, 16, 2, 64, 64, generator=gen).to(torch.bfloat16)
    images = (torch.rand(1, 3, 5, 448, 448, generator=gen) * 2 - 1
              ).to(torch.bfloat16)
    ref = ca.forward_with_latent(model, latent, images, cfg, device="cpu")
    before = (fa.launches_unmasked, fa.launches_masked)
    out = ca.forward_with_latent(model.to("cuda"), latent, images, cfg)
    torch.cuda.synchronize()
    check(fa.launches_unmasked > before[0] and fa.launches_masked > before[1],
          "the narrow decoder did not reach both kernel entries")
    errs = {}
    for name, a, b in (
            ("depth", out.depth, ref.depth),
            ("depth_conf", out.depth_conf, ref.depth_conf),
            ("means", out.gaussians.means, ref.gaussians.means),
            ("covariances", out.gaussians.covariances,
             ref.gaussians.covariances),
            ("harmonics", out.gaussians.harmonics, ref.gaussians.harmonics),
            ("pose_enc", out.pred_pose_enc_list[-1],
             ref.pred_pose_enc_list[-1]),
            ("extrinsic_c2w", out.extrinsic_c2w, ref.extrinsic_c2w),
            ("intrinsic_norm", out.intrinsic_norm, ref.intrinsic_norm)):
        a, b = a.float().cpu(), b.float()
        check(bool(torch.isfinite(a).all()), f"non-finite {name} on the card")
        errs[name] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)
                      ).item()
    # pixels that cross the 10 % confidence quantile between the two runs
    errs["conf_mask_disagree"] = (out.conf_valid_mask.cpu()
                                  != ref.conf_valid_mask).float().mean().item()
    log(f"{label}: card vs host CPU, max |Δ| / max |ref|: {errs}")
    # Both sides run a bf16 trunk but round at different places (kernel
    # vs plain softmax, cuBLAS vs CPU matmuls); 2^-5 of the output's range
    # separates that rounding from a wrong layout or mask.
    bad = {k: v for k, v in errs.items() if not v <= 2 ** -5}
    check(not bad, f"{label}: card and host CPU disagree: {bad}")
    return errs


def reference_dit() -> dict:
    """A narrow Wan DiT at the full token count (latent (2, 16, 4, 64, 64):
    4096 tokens, 2 heads of 128, 2 layers, 226 text tokens), bf16, on the
    card (the natural-layout kernel, one launch per layer; cross-attention
    on plain math) and on the host CPU (plain attention), with the same
    weights and inputs."""
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.nn import wan_dit

    cfg = wan_dit.WanDiTConfig(dim=256, ffn_dim=1024, num_layers=2,
                               num_heads=2, text_dim=256)
    gen = torch.Generator().manual_seed(6)
    dit = wan_dit.init(cfg, gen, device="cpu", dtype=torch.bfloat16)
    latent = torch.randn(2, 16, 4, 64, 64, generator=gen).to(torch.bfloat16)
    ts = torch.tensor([999.0, 417.0])
    text = torch.randn(2, 226, cfg.text_dim, generator=gen).to(torch.bfloat16)
    ref = wan_dit.forward(dit, latent, ts, text).float()
    before = fa.launches_natural
    out = wan_dit.forward(dit.to("cuda"), latent.cuda(), ts.cuda(),
                          text.cuda())
    torch.cuda.synchronize()
    launched = fa.launches_natural - before
    check(launched == cfg.num_layers,
          f"narrow DiT: {launched} natural launches, want {cfg.num_layers}")
    out = out.float().cpu()
    check(bool(torch.isfinite(out).all()), "non-finite DiT output on the card")
    diff = (out - ref).abs()
    errs = {"dit_velocity": (diff.max() / ref.abs().max()).item(),
            "dit_velocity_mean": (diff.mean() / ref.abs().mean()).item()}
    log(f"reference: narrow DiT (4096 tokens, D = 128), card vs host CPU, "
        f"max |Δ| / max |ref| {errs['dit_velocity']:.4g}, mean |Δ| / mean "
        f"|ref| {errs['dit_velocity_mean']:.4g}")
    # bf16 activations rounded at other places (kernel vs plain softmax,
    # cuBLAS vs CPU matmuls): a few bf16 steps; 2⁻⁵ of the output's range
    # separates that from a wrong RoPE, layout or head split
    check(errs["dit_velocity"] <= 2 ** -5,
          f"narrow DiT: card and host CPU disagree: {errs}")
    return errs


def orbit_cameras(out):
    """A decode's 13 context cameras interpolated as the export does."""
    from vist3a_tpu_torch.io.video_export import interpolate_cameras

    ex, kk = interpolate_cameras(out.extrinsic_c2w.float().cpu().numpy(),
                                 out.intrinsic_norm.float().cpu().numpy(),
                                 ORBIT_T)
    check(ex.shape[1] == ORBIT_VIEWS, f"{ex.shape[1]} orbit views")
    return ex, kk


def orbit_view(cams, view: int):
    """World→camera matrix and pixel K of orbit view `view`."""
    import torch

    ex, kk = cams
    viewmat = torch.linalg.inv(torch.from_numpy(ex[0, view]).cuda())
    K = torch.from_numpy(kk[0, view]).cuda() \
        * torch.tensor([[IMAGE], [IMAGE], [1.0]], device="cuda")
    return viewmat, K


def composite_bound(pairs, n_eval, n_comp) -> dict:
    """The least time the card needs for this view's composite: the fp32
    operations that no implementation avoids — each composited (pixel,
    pair)'s evaluation and composition — and the bytes of the ids and rows
    the tiles must read (each Gaussian's row once) plus the bounds and the
    six output planes.  Each pixel's stopping pair (at most one a pixel,
    200,704 at 448²) is evaluated too but left out of the count, as are the
    evaluations a cull skips; `ops_all_evaluated` keeps the count of every
    (pixel, pair) up to the stop, the bound before the kernels culled."""
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr

    n_comp = int(n_comp.sum())
    ops = (OPS_PER_EVAL + OPS_PER_COMPOSITE) * n_comp
    ops_all = OPS_PER_EVAL * int(n_eval.sum()) + OPS_PER_COMPOSITE * n_comp
    _, need = tile_walks(pairs, n_eval)
    n_rows = torch.unique(pairs.gid[need]).numel()
    n_bytes = 4 * int(need.sum()) + 4 * tr.N_ATTR * n_rows \
        + 4 * pairs.bounds.numel() + 4 * tr.N_OUT * IMAGE * IMAGE
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return {"ops": ops, "ops_all_evaluated": ops_all,
            "bound_all_evaluated_ms": max(ops_all / PEAK_FP32_FLOPS * 1e3,
                                          bytes_ms),
            "bytes": n_bytes, "pairs_walked": int(need.sum()),
            "rows_read": n_rows, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def tile_walks(pairs, n_eval):
    """Each tile's walk (the pairs up to its last pixel's stop) and the
    (P,) mask of the pairs within it."""
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr

    nt = IMAGE // tr.TILE
    walk = n_eval.reshape(nt, tr.TILE, nt, tr.TILE).amax((1, 3)).flatten()
    idx = torch.arange(pairs.gid.numel(), device=walk.device)
    bounds = pairs.bounds.long()
    tile = torch.searchsorted(bounds[1:], idx, right=True)
    return walk, (idx - bounds[tile]) < walk[tile]


def cull_stats(pairs, table, n_eval, walked, composited,
               batch: int) -> dict:
    """The cull on this view, figures of the plain versions: the mask of
    `subtile_mask_ref` and the (warp, pair) walk of
    `composite_ref(warp_work=True)` (`walked`, `composited`), not read back
    from the kernel. Each tile's walk (the pairs up to its last pixel's
    stop), largest and mean; the share of (warp, pair)s kept over the whole
    stream and over the pairs the tiles walk up to their stop; and, over
    each warp's own walk, the (warp, pair)s it walks, those it keeps, and
    those some lane of it composites, whose gradients the backward reduces.
    `warp_imbalance`: over stages of `batch` pairs, between two of which a
    block waits for its slowest warp, Σ max over the warps of the kept and
    composited (warp, pair)s over Σ their mean (1 if every warp of a stage
    had as many); `warp_imbalance_tile` the same over whole tiles, the part
    that no scheduling of a tile's fixed warps can remove."""
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr

    walk, need = tile_walks(pairs, n_eval)
    mask = tr.subtile_mask_ref(table, IMAGE // tr.TILE, IMAGE, IMAGE,
                               pairs.gid, pairs.bounds)
    warps = torch.arange(tr.N_WARPS, device=table.device)[:, None]
    kept = ((mask[None] >> warps) & 1).bool()
    check(not bool((composited & ~kept).any()),
          "the cull drops a (warp, pair) that composites")
    work = (walked & kept).float() + composited.float()
    idx = torch.arange(mask.numel(), device=table.device)
    bounds = pairs.bounds.long()
    tile = torch.searchsorted(bounds[1:], idx, right=True)
    stage = tile * (int(torch.diff(bounds).max()) // batch + 1) \
        + torch.div(idx - bounds[tile], batch, rounding_mode="floor")
    _, stage = torch.unique(stage, return_inverse=True)

    def imbalance(group):
        w = torch.zeros(tr.N_WARPS, int(group.max()) + 1,
                        device=table.device).index_add_(1, group, work)
        return w.amax(0).sum().item() / max(w.mean(0).sum().item(), 1e-30)

    return {"walk_max": int(walk.max()),
            "walk_mean": walk.float().mean().item(),
            "kept_share": kept.sum().item() / kept.numel(),
            "kept_share_walked": kept[:, need].sum().item()
            / (tr.N_WARPS * max(int(need.sum()), 1)),
            "warp_pairs_walked": int(walked.sum()),
            "warp_pairs_kept": int((walked & kept).sum()),
            "warp_pairs_active": int(composited.sum()),
            "warp_imbalance": imbalance(stage),
            "warp_imbalance_tile": imbalance(tile)}


def ptxas_summary(source: str) -> dict:
    """Registers and spill bytes ptxas reported for `source`'s kernels."""
    import re

    from vist3a_tpu_torch.kernels import build

    text = build.build_logs.get(source, "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    return {"registers": regs, "spill_bytes": spills} if regs \
        else {"registers": None, "spill_bytes": None}


def camera_spread(c2w) -> tuple[float, float]:
    """Largest rotation angle (degrees) and camera-centre distance of the
    13 context cameras from the first."""
    import torch

    c2w = c2w[0].float()
    rel = c2w[0, :3, :3].T @ c2w[:, :3, :3]
    cos = ((rel.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2).clamp(-1, 1)
    dist = (c2w[:, :3, 3] - c2w[0, :3, 3]).norm(dim=-1)
    return (torch.rad2deg(torch.acos(cos)).max().item(),
            dist.max().item())


def compare_composite(tr, gid, bounds, table, ntx: int, width: int,
                      height: int):
    """The composite kernel against `composite_ref` on one view: each plane
    within `RASTER_ATOL` of its scale on all but `RASTER_MAX_OFF_SHARE` of
    the pixels → (result, passed, (kernel output, plain output, work)),
    `work` the plain version's counts (`composite_ref(warp_work=True)`)."""
    import torch

    args = (gid, bounds, table, ntx, width, height)
    img = tr.composite(*args)
    torch.cuda.synchronize()
    ref, *work = tr.composite_ref(*args, return_work=True, warp_work=True)
    check(bool(torch.isfinite(img).all()), "non-finite composite output")
    diff = (img - ref).abs()
    scale = ref.abs().flatten(1).amax(1).clamp_min(1.0)[:, None, None]
    off = (diff > RASTER_ATOL * scale).any(0)
    share = off.float().mean().item()
    planes = ("r", "g", "b", "depth", "alpha", "T")
    res = {"max_abs_err": diff.max().item(), "off_share": share,
           "off_pixels": int(off.sum()),
           "max_abs_err_by_plane": {k: diff[i].max().item()
                                    for i, k in enumerate(planes)}}
    return res, share <= RASTER_MAX_OFF_SHARE, (img, ref, work)


def raster_view(g, cams, view: int) -> dict:
    """The composite kernel against its plain version on one orbit view,
    both timed, with the view's bound, its walk and its cull."""
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr

    n_gauss = g.means.shape[1]
    budget = tr.default_pair_budget(n_gauss)
    viewmat, K = orbit_view(cams, view)
    table, pairs = tr.view_pairs(g.means[0], g.covariances[0],
                                 g.harmonics[0], g.opacities[0], viewmat, K,
                                 IMAGE, IMAGE, budget)
    n_pairs = pairs.gid.numel()
    log(f"raster: G={n_gauss}, orbit view {view} of {ORBIT_VIEWS} at "
        f"{IMAGE}², pair budget {budget}: {pairs.total} pairs, "
        f"{n_pairs} kept, {pairs.total - n_pairs} cut by the budget; "
        f"{int((table[:, 5] > 0).sum())} Gaussians valid with opacity > 0")
    check(n_pairs > 0, f"orbit view {view} is empty: nothing to composite")
    ntx = IMAGE // tr.TILE
    args = (pairs.gid, pairs.bounds, table, ntx, IMAGE, IMAGE)
    cmp, passed, (_, ref, work) = compare_composite(tr, *args)
    n_eval, n_comp, _, walked, composited = work
    log(f"raster: view {view}: kernel vs plain {json.dumps(cmp)}; covered "
        f"(alpha > 0.5) {(ref[4] > 0.5).float().mean().item():.4f}")
    check(passed, f"composite kernel disagrees with composite_ref on "
          f"{cmp['off_share']:.3g} of the pixels of view {view} (allowed "
          f"{RASTER_MAX_OFF_SHARE})")
    kernel_ms = cuda_events_ms(lambda: tr.composite(*args), iters=20)
    plain_ms = cuda_events_ms(lambda: tr.composite_ref(*args), iters=1,
                              warmup=0)
    bound = composite_bound(pairs, n_eval, n_comp)
    res = {"view": view, "gaussians": n_gauss, "pairs": n_pairs,
           "pairs_total": pairs.total, "pairs_cut": pairs.total - n_pairs,
           "evaluations": int(n_eval.sum()), "composited": int(n_comp.sum()),
           "max_abs_err": cmp["max_abs_err"], "off_share": cmp["off_share"],
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, **bound,
           "share_of_bound": bound["bound_ms"] / kernel_ms,
           "plain": cull_stats(pairs, table, n_eval, walked, composited,
                               batch=256)}
    log(f"raster: {json.dumps(res)}")
    log_view("forward", res)
    return {**res, "backward": raster_view_backward(g, cams, view)}


def log_view(kind: str, res: dict) -> None:
    """One composite kernel's time on a view beside its bound, then the
    plain versions' figures of the cull and the walk (`res["plain"]`: the
    kernel's own are not read back); a share of the bound over 1 fails
    (the bound is wrong)."""
    check(res["share_of_bound"] <= 1, f"the {kind} beat its bound: {res}")
    p = res["plain"]
    log(f"raster: view {res['view']}: {kind} {res['kernel_ms']:.4f} ms, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}), share of the "
        f"bound {res['share_of_bound']:.4f} (bound with every evaluation up "
        f"to the stop {res['bound_all_evaluated_ms']:.4f} ms); the plain "
        f"versions' figures: kept (warp, pair)s {p['kept_share']:.4f} of "
        f"the stream, {p['kept_share_walked']:.4f} of the walk, "
        f"{p['warp_pairs_active']} of {p['warp_pairs_kept']} kept "
        f"composited by some lane, imbalance a stage "
        f"{p['warp_imbalance']:.3f}, a tile {p['warp_imbalance_tile']:.3f}; "
        f"tile walk largest {p['walk_max']}, mean {p['walk_mean']:.1f} "
        f"pairs")


def compare_composite_bwd(tr, gid, bounds, table, out, gout, ntx: int,
                          width: int, height: int):
    """The composite backward kernel against `composite_bwd_ref` on one
    view: per column the share of pairs beyond `RASTER_BWD_RTOL` of the
    column's largest, the largest error against `RASTER_BWD_MAX_REL`, and
    the same bits twice → (result, passed, the kernel's rows)."""
    import torch

    got = tr.composite_bwd(gid, bounds, table, out, gout, ntx, width,
                           height)
    again = tr.composite_bwd(gid, bounds, table, out, gout, ntx, width,
                             height)
    torch.cuda.synchronize()
    ref = tr.composite_bwd_ref(gid, bounds, table, out, gout, ntx, width,
                               height)
    check(bool(torch.isfinite(got).all()), "non-finite composite gradients")
    diff = (got - ref).abs()
    scale = ref.abs().amax(0).clamp_min(1e-30)
    off = (diff > RASTER_BWD_RTOL * scale).any(1)
    share = off.float().mean().item()
    cols = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity",
            "r", "g", "b", "depth")
    res = {"max_abs_err": diff.max().item(), "off_share": share,
           "max_rel_err_by_column": {c: (diff[:, i].max() / scale[i]).item()
                                     for i, c in enumerate(cols)},
           "bitwise_repeatable": torch.equal(got, again)}
    passed = (share <= RASTER_BWD_MAX_OFF_SHARE
              and max(res["max_rel_err_by_column"].values())
              <= RASTER_BWD_MAX_REL and res["bitwise_repeatable"])
    return res, passed, got


def composite_bwd_bound(tr, pairs, n_eval, n_comp, n_clamp) -> dict:
    """The least time the card needs for this view's composite backward:
    the fp32 operations no implementation avoids — each composited (pixel,
    pair)'s evaluation, transmittance step and gradients, fewer where α
    was clamped (each pixel's stopping pair, at most 200,704 evaluations,
    is left out, as in `composite_bound`; `ops_all_evaluated` counts every
    (pixel, pair) up to the stop) — and the bytes: the ids, rows and
    gradient rows of the pairs walked, each Gaussian's row once, the
    bounds, and the saved output and its cotangent (6 planes each)."""
    fwd = composite_bound(pairs, n_eval, n_comp)
    n_comp, n_clamp = int(n_comp.sum()), int(n_clamp.sum())
    ops = (OPS_PER_EVAL + OPS_BWD_PER_COMPOSITE) * n_comp \
        - OPS_BWD_CLAMP_SKIPS * n_clamp
    ops_all = OPS_PER_EVAL * int(n_eval.sum()) \
        + OPS_BWD_PER_COMPOSITE * n_comp - OPS_BWD_CLAMP_SKIPS * n_clamp
    n_bytes = fwd["bytes"] + 4 * tr.N_OUT * IMAGE * IMAGE \
        + 4 * tr.N_ATTR * fwd["pairs_walked"]
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return {"ops": ops, "ops_all_evaluated": ops_all,
            "bound_all_evaluated_ms": max(ops_all / PEAK_FP32_FLOPS * 1e3,
                                          bytes_ms),
            "bytes": n_bytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def raster_view_backward(g, cams, view: int) -> dict:
    """Kernel 7 on one orbit view at the reward path's pair budget
    (latent_t·448²), given a random cotangent, against its plain version;
    both timed, with the bound."""
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr

    budget = stitched_config().latent_t * IMAGE * IMAGE
    viewmat, K = orbit_view(cams, view)
    table, pairs = tr.view_pairs(g.means[0], g.covariances[0],
                                 g.harmonics[0], g.opacities[0], viewmat, K,
                                 IMAGE, IMAGE, budget)
    ntx = IMAGE // tr.TILE
    out = tr.composite(pairs.gid, pairs.bounds, table, ntx, IMAGE, IMAGE)
    gen = torch.Generator(device="cuda").manual_seed(30 + view)
    gout = torch.randn(out.shape, generator=gen, device="cuda")
    args = (pairs.gid, pairs.bounds, table, out, gout, ntx, IMAGE, IMAGE)
    res, passed, _ = compare_composite_bwd(tr, *args)
    check(passed, f"composite backward disagrees with composite_bwd_ref on "
          f"view {view}: {res} (limits {RASTER_BWD_RTOL}, "
          f"{RASTER_BWD_MAX_OFF_SHARE}, {RASTER_BWD_MAX_REL})")
    _, n_eval, n_comp, n_clamp, walked, composited = tr.composite_ref(
        pairs.gid, pairs.bounds, table, ntx, IMAGE, IMAGE, return_work=True,
        warp_work=True)
    kernel_ms = cuda_events_ms(lambda: tr.composite_bwd(*args), iters=10)
    plain_ms = cuda_events_ms(lambda: tr.composite_bwd_ref(*args), iters=1,
                              warmup=0)
    bound = composite_bwd_bound(tr, pairs, n_eval, n_comp, n_clamp)
    res.update(view=view, pair_budget=budget, pairs=pairs.gid.numel(),
               pairs_total=pairs.total, kernel_ms=kernel_ms,
               plain_ms=plain_ms, clamped=int(n_clamp.sum()),
               evaluations=int(n_eval.sum()), composited=int(n_comp.sum()),
               **bound, share_of_bound=bound["bound_ms"] / kernel_ms,
               plain=cull_stats(pairs, table, n_eval, walked, composited,
                                batch=128))
    log(f"raster: backward {json.dumps(res)}")
    log_view("backward", res)
    return res


def raster_scene(model):
    """One full-width scene: the Gaussians of a stitched-decoder request
    from seeded inputs and its 13 context cameras interpolated to the
    orbit → (gaussians, cameras)."""
    import torch

    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    gen = torch.Generator(device="cuda").manual_seed(2)
    latent = torch.randn(1, 16, 4, 64, 64, generator=gen, device="cuda"
                         ).to(torch.bfloat16)
    images = (torch.rand(1, 3, 13, 448, 448, generator=gen, device="cuda")
              * 2 - 1).to(torch.bfloat16)
    out = ca.forward_with_latent(model, latent, images, stitched_config())
    angle, dist = camera_spread(out.extrinsic_c2w)
    log(f"raster: the 13 context cameras span {angle:.4f}° of rotation and "
        f"{dist:.6g} of camera-centre distance from the first")
    check(angle > 0.1 or dist > 1e-3,
          "the 13 context cameras coincide: the orbit does not move")
    return out.gaussians, orbit_cameras(out)


def phase_raster(model) -> list:
    from vist3a_tpu_torch.kernels import rasterizer as tr

    gaussians, cams = raster_scene(model)
    views = [raster_view(gaussians, cams, v) for v in RASTER_VIEWS]
    log("raster: library_ms null — no PyTorch call computes a front-to-back "
        "alpha composite over sorted (tile, depth) pairs, nor its backward")
    log("raster: ptxas " + json.dumps(
        {src: ptxas_summary(src) for src in (tr.SOURCE, tr.BWD_SOURCE)}))
    return views


def build_vae():
    import torch

    from vist3a_tpu_torch.nn import wan_vae
    from vist3a_tpu_torch.pipelines import t23d

    cfg = t23d.T23DConfig()
    check(cfg.stitched == stitched_config(), "stitched configs differ")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    vae = wan_vae.init_decoder(cfg.vae, gen, device="cuda",
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model: WanVAEConfig() decoder, "
        f"{sum(p.numel() for p in vae.parameters())} parameters (bf16), built "
        f"in {time.perf_counter() - t0:.1f} s")
    return vae


def _check_artifacts(arts) -> str:
    """The orbit frames, both mp4s and the PLY a request wrote; returns a
    summary for the log."""
    import numpy as np

    from vist3a_tpu_torch.io.ply_export import load_ply

    check(arts.color.shape == (ORBIT_VIEWS, 3, IMAGE, IMAGE),
          f"frames {arts.color.shape}")
    check(bool(np.isfinite(arts.color).all())
          and arts.color.min() >= 0 and arts.color.max() <= 1,
          "orbit frames not finite in [0, 1]")
    check(bool(np.isfinite(arts.depth).all()), "non-finite depth")
    n_vertices = len(load_ply(arts.ply_path)["x"])
    check(n_vertices == GAUSSIANS, f"PLY has {n_vertices} vertices")
    mp4_bytes = [os.path.getsize(p) for p in (arts.gs_path, arts.depth_path)]
    check(min(mp4_bytes) > 0, f"empty mp4 files {mp4_bytes}")
    return (f"frames mean {arts.color.mean():.4f}, PLY {n_vertices} "
            f"vertices, {os.path.getsize(arts.ply_path)} B, gs.mp4 + "
            f"depth.mp4 {mp4_bytes} B")


def _check_summary(summary: dict, n_gauss: int) -> str:
    """`_check_output` and `_check_artifacts` on what
    `cli/inference_t23d.py::run` keeps of a request (`summarize`)."""
    from vist3a_tpu_torch.io.ply_export import load_ply

    shapes = summary["shapes"]
    for name, shape in (("means", (1, n_gauss, 3)),
                        ("covariances", (1, n_gauss, 3, 3)),
                        ("harmonics", (1, n_gauss, 3, 25)),
                        ("opacities", (1, n_gauss))):
        check(shapes[name] == shape, f"{name} {shapes[name]}, want {shape}")
    check(summary["frames_shape"] == (ORBIT_VIEWS, 3, IMAGE, IMAGE),
          f"frames {summary['frames_shape']}")
    lo, hi = summary["frames_range"]
    check(summary["frames_finite"] and lo >= 0 and hi <= 1,
          "orbit frames not finite in [0, 1]")
    check(summary["depth_finite"], "non-finite depth")
    paths = summary["paths"]
    n_vertices = len(load_ply(paths["ply"])["x"])
    check(n_vertices == n_gauss, f"PLY has {n_vertices} vertices")
    mp4_bytes = [os.path.getsize(paths[k]) for k in ("gs", "depth")]
    check(min(mp4_bytes) > 0, f"empty mp4 files {mp4_bytes}")
    return (f"frames mean {summary['frames_mean']:.4f}, PLY {n_vertices} "
            f"vertices, {os.path.getsize(paths['ply'])} B, gs.mp4 + "
            f"depth.mp4 {mp4_bytes} B")


def _check_frames_on_card(arts, written: dict, frames_on_card: int) -> dict:
    """The uint8 frames the export made on the card and handed to the two
    mp4 writers (`written`, by file name) against the numpy path
    (`to_uint8_frames`, `turbo_depth`) run on the request's host copies of
    the float frames, and the frames `orbit_uint8_frames` counted."""
    import numpy as np

    from vist3a_tpu_torch.io.video_export import to_uint8_frames, turbo_depth

    t0 = time.perf_counter()
    want = {"gs.mp4": to_uint8_frames(arts.color),
            "depth.mp4": to_uint8_frames(turbo_depth(arts.depth, 13))}
    numpy_s = time.perf_counter() - t0
    bytes_off = {name: int(np.count_nonzero(written[name] != w))
                 if written[name].shape == w.shape else -1
                 for name, w in want.items()}
    check(bytes_off == {"gs.mp4": 0, "depth.mp4": 0},
          f"mp4 frames off the numpy path's: {bytes_off} bytes")
    check(frames_on_card == 2 * ORBIT_VIEWS,
          f"frames_on_card {frames_on_card}, want {2 * ORBIT_VIEWS}")
    return {"bytes_equal": True, "bytes_off": bytes_off,
            "frames_on_card": frames_on_card,
            "numpy_path_s": round(numpy_s, 3)}


def phase_decode(model, vae, profile: bool) -> dict:
    import torch

    from vist3a_tpu_torch.io import video_export
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import rasterizer as tr
    from vist3a_tpu_torch.pipelines import t23d

    cfg = t23d.T23DConfig()
    zgen = torch.Generator(device="cuda").manual_seed(3)
    latents = torch.randn(cfg.latent_shape, generator=zgen, device="cuda")

    def request(save_path):
        out, video = t23d.decode_and_reconstruct(vae, model, latents, cfg)
        arts = t23d.export_artifacts(
            out.gaussians, out.extrinsic_c2w, out.intrinsic_norm, save_path,
            (IMAGE, IMAGE), orbit_t=ORBIT_T)
        return out, video, arts

    # the frames each mp4 writer is handed, for the check against the
    # numpy path
    written = {}
    write_mp4 = video_export.write_mp4

    def capture(video, path, fps=20):
        written[os.path.basename(path)] = video
        return write_mp4(video, path, fps)

    tmp = tempfile.mkdtemp(prefix="vist3a_decode_")
    latencies, peaks, exports = [], [], []
    counts = {"unmasked": 0, "masked": 0, "composite": 0}
    video_export.write_mp4 = capture
    try:
        for i in range(DECODE_REQUESTS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            tr.reset_launch_counts()
            video_export.reset_frame_counts()
            t0 = time.perf_counter()
            out, video, arts = request(os.path.join(tmp, f"scene{i}"))
            torch.cuda.synchronize()
            latencies.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated())
            grew = {"unmasked": fa.launches_unmasked,
                    "masked": fa.launches_masked, "composite": tr.launches}
            want = {**LAUNCHES_PER_REQUEST, "composite": ORBIT_VIEWS}
            check(grew == want, f"decode request {i}: launches {grew}, "
                  f"want {want}")
            for k in counts:
                counts[k] += grew[k]
            check(tuple(video.shape) == (1, 3, 13, 512, 512),
                  f"video {tuple(video.shape)}")
            check(bool(torch.isfinite(video).all())
                  and float(video.abs().max()) <= 1.0, "video not in [−1, 1]")
            _check_output(out, GAUSSIANS)
            summary = _check_artifacts(arts)
            exports.append(_check_frames_on_card(
                arts, written, video_export.frames_on_card))
            log(f"decode: request {i}: {latencies[-1]:.1f} ms, launches "
                f"{grew}, video {tuple(video.shape)} in "
                f"[{video.min().item():.4f}, {video.max().item():.4f}], "
                f"{summary}, peak memory {peaks[-1]} B")
            del out, video, arts
            shutil.rmtree(os.path.join(tmp, f"scene{i}"), ignore_errors=True)
        log(f"decode: latency ms {latencies}; peak memory allocated {peaks}; "
            f"launches {counts}; export {json.dumps(exports)}")
        if profile:
            profile_call("decode", lambda: request(os.path.join(tmp, "prof")),
                         DECODE_STAGES, RENDER_STAGES)
    finally:
        video_export.write_mp4 = write_mp4
        shutil.rmtree(tmp, ignore_errors=True)
    return {"latency_ms": latencies, "peak_bytes": peaks, "launches": counts,
            "export": exports}


def fake_tokenizer(cfg):
    """A stand-in for the HF tokenizer (the weights, and with them the
    vocabulary, are not in the repository): ids seeded by the text, padded
    to `cfg.max_sequence_length` (226), the mask as long as the text has
    words."""
    import numpy as np

    def tokenize(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        n = cfg.max_sequence_length
        ids = rng.integers(0, cfg.vocab_size, (1, n))
        mask = np.zeros((1, n), np.int64)
        mask[0, :min(len(text.split()), n)] = 1
        return ids, mask
    return tokenize


def build_generator(cfg):
    """UMT5 and the Wan DiT of `cfg` in bf16, their random weights drawn on
    the card from a seeded generator."""
    import torch

    from vist3a_tpu_torch.nn import umt5, wan_dit

    gen = torch.Generator(device="cuda").manual_seed(4)
    models = {}
    for name, mod, mcfg in (("umt5", umt5, cfg.umt5),
                            ("dit", wan_dit, cfg.dit)):
        t0 = time.perf_counter()
        models[name] = mod.init(mcfg, gen, device="cuda",
                                dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in models[name].parameters())
        log(f"model: {type(mcfg).__name__} {name}, {n} parameters (bf16), "
            f"built on the card in {time.perf_counter() - t0:.1f} s")
    return models


def phase_denoise(model, vae, profile: bool) -> dict:
    """One whole text→3DGS request through `text_to_3dgs`: UMT5-XXL, 50
    UniPC steps with CFG over the Wan 1.3B DiT, the decode and the export;
    then the denoise's ms per step and a profile of 2 steps, and with
    `profile` the whole request under the profiler (each range's host and
    device time)."""
    import torch

    from vist3a_tpu_torch.pipelines import t23d

    cfg = t23d.T23DConfig()
    modules = {**build_generator(cfg), "vae": vae, "stitched": model}
    tokenize = fake_tokenizer(cfg.umt5)
    want = {**LAUNCHES_PER_REQUEST, "composite": ORBIT_VIEWS,
            "natural": cfg.dit.num_layers * cfg.num_inference_steps,
            "qk_prologue": 3 * cfg.dit.num_layers * cfg.num_inference_steps}

    def request(save_path):
        return t23d.text_to_3dgs(modules, tokenize, PROMPT, save_path, cfg,
                                 orbit_t=ORBIT_T)

    tmp = tempfile.mkdtemp(prefix="vist3a_t23d_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = request(os.path.join(tmp, "scene"))
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
        counts = {k: _vdm_counts()[k] for k in want}
        peak = torch.cuda.max_memory_allocated()
        check(counts == want, f"text_to_3dgs: launches {counts}, want {want}")
        lat = res.latents
        check(tuple(lat.shape) == cfg.latent_shape
              and lat.dtype == torch.float32, f"latents {tuple(lat.shape)}")
        check(bool(torch.isfinite(lat).all()), "non-finite latents")
        _check_output(res.output, GAUSSIANS)
        summary = _check_artifacts(res.artifacts)
        log(f"denoise: text_to_3dgs request {latency:.1f} ms, launches "
            f"{counts}, latents {tuple(lat.shape)} mean "
            f"{lat.mean().item():.4f} std {lat.std().item():.4f} range "
            f"[{lat.min().item():.4f}, {lat.max().item():.4f}], {summary}, "
            f"peak memory allocated {peak} B")
        del res

        # the denoise alone, 2 steps: ms per step, then its profile
        two = dataclasses.replace(cfg, num_inference_steps=2)
        cond, uncond = t23d.embed_prompts(modules["umt5"], tokenize, PROMPT)
        z = torch.randn(cfg.latent_shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
        steps_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t23d.denoise(modules["dit"], cond, uncond, two, latents0=z)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3 / 2)
        log(f"denoise: ms per step (CFG pair, 2-step denoise, twice) "
            f"{steps_ms}")
        profile_call("denoise_2_steps", lambda: t23d.denoise(
            modules["dit"], cond, uncond, two, latents0=z))
        if profile:
            # the request's own stages, the prompt embedding and the
            # denoise cut to a few steps (the decode's and the export's
            # are profile[decode]'s): the profile's event walk takes host
            # time per launch, and a 50-step request launches ~221,000
            # kernels
            short = dataclasses.replace(
                cfg, num_inference_steps=T23D_PROFILE_STEPS)

            def embed_and_denoise():
                c, u = t23d.embed_prompts(modules["umt5"], tokenize, PROMPT)
                t23d.denoise(modules["dit"], c, u, short, latents0=z)
            profile_call(f"t23d_embed_denoise_{T23D_PROFILE_STEPS}_steps",
                         embed_and_denoise, T23D_STAGES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"latency_ms": latency, "peak_bytes": peak, "launches": counts,
            "ms_per_step": steps_ms}


SAFETENSORS_DTYPES = {"torch.float32": "F32", "torch.bfloat16": "BF16",
                      "torch.float16": "F16", "torch.int64": "I64"}


def write_safetensors(path, tensors: dict) -> int:
    """A minimal safetensors writer (the card machine has no `safetensors`
    package): the 8-byte little-endian header length, the JSON header padded
    to 8 bytes, then each tensor's bytes in header order.  Returns the
    bytes written."""
    import struct

    import torch

    names = sorted(tensors)
    header, offset = {}, 0
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype)],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(head) + offset


def write_sharded(folder: Path, tensors: dict, shards: int) -> int:
    """HF's sharded layout: `model-0000i-of-0000n.safetensors` and
    `model.safetensors.index.json`."""
    names = sorted(tensors)
    per = -(-len(names) // shards)
    weight_map, total = {}, 0
    for i in range(shards):
        shard = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[i * per:(i + 1) * per]}
        total += write_safetensors(folder / shard, part)
        weight_map.update({n: shard for n in part})
    (folder / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def _saved_site(site: str, k_chop: int) -> str:
    """The stitched model's (the reference's) name of an encoder site: the
    ViT blocks before the chop are deleted there, so block i is saved as
    i − k."""
    import re

    from vist3a_tpu_torch.io import weight_import as wi

    ref = wi.encoder_to_reference(site + ".")[:-1]
    return "encoder." + re.sub(
        r"^aggregator\.patch_embed\.blocks\.(\d+)",
        lambda m: f"aggregator.patch_embed.blocks.{int(m[1]) - k_chop}", ref)


def stitched_checkpoint(encoder, scfg, lora_cfg, gen) -> tuple:
    """A reference-format `stitched_model_epoch_N.pth` for the sites of the
    encoder chopped at `scfg.stitch_layer_index`: nonzero LoRA factors
    (torch's lora_A (r·k, in·k), lora_B (out·k, r·k)) on every site, every
    site's bias nudged (bias="lora_only"), a random stitch conv and the
    three token tensors.  Returns (that dict, the port-named factors
    {site: {"a", "b"}} and biases {"<site>.bias": tensor} it holds)."""
    import torch

    from vist3a_tpu_torch.io import weight_import as wi
    from vist3a_tpu_torch.nn.encoder import Encoder
    from vist3a_tpu_torch.stitch import lora as lora_mod

    k = scfg.stitch_layer_index
    student = wi.on_meta(lambda: Encoder(scfg.encoder, vit_start=k))
    modules = dict(encoder.named_modules())
    lora, factors, biases = {}, {}, {}
    for site in lora_mod.lora_sites(student, lora_cfg):
        m = modules[site]
        (a_shape, b_shape, fan_in) = lora_mod._factor_shapes(m.weight.shape,
                                                             lora_cfg.r)
        a = (torch.rand(a_shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)
        b = torch.randn(b_shape, generator=gen) * 1e-3
        name = _saved_site(site, k)
        lora[f"{name}.lora_A"] = a.T.contiguous()
        lora[f"{name}.lora_B"] = b.T.contiguous()
        factors[site] = {"a": a, "b": b}
        if m.bias is not None:
            bias = m.bias.detach().float().cpu() \
                + 1e-3 * torch.randn(m.bias.shape, generator=gen)
            lora[f"{name}.bias"] = bias
            biases[f"{site}.bias"] = bias
    cshape = (scfg.conv.out_channels, scfg.latent_channels,
              *scfg.conv.kernel_shape(1)[2:])
    bound = 1.0 / math.sqrt(math.prod(cshape[1:]))
    d = scfg.encoder.vit.embed_dim
    ck = {"lora": lora,
          "stitching_layer": {
              "weight": (torch.rand(cshape, generator=gen) * 2 - 1) * bound,
              "bias": (torch.rand(cshape[0], generator=gen) * 2 - 1) * bound},
          "mask_token": torch.zeros(1, d),
          "cls_token": torch.randn(1, 1, d, generator=gen) * 1e-6,
          "register_tokens": torch.randn(
              1, scfg.encoder.vit.num_register_tokens, d, generator=gen)
          * 1e-6}
    return ck, factors, biases


def peft_adapter(cfg, gen, r: int) -> tuple[dict, dict]:
    """A PEFT adapter of rank r on q/k/v/o of both attention blocks of every
    block of a DiT of config `cfg`, lora_B nonzero: ({"base_model.model.
    blocks.{i}.attn1.to_q.lora_A.weight": (r, in), "….lora_B.weight":
    (out, r), ...}, the same factors keyed by the port's weight names
    {name: (A, B)})."""
    import torch

    adapter, factors = {}, {}
    d = cfg.dim
    for i in range(cfg.num_layers):
        for attn in ("attn1", "attn2"):
            for proj, ours in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"),
                               ("to_out.0", "o")):
                a = (torch.rand(r, d, generator=gen) * 2 - 1) / math.sqrt(d)
                b = torch.randn(d, r, generator=gen) * 1e-3
                p = f"base_model.model.blocks.{i}.{attn}.{proj}"
                adapter[f"{p}.lora_A.weight"] = a
                adapter[f"{p}.lora_B.weight"] = b
                factors[f"blocks.{i}.{attn}.{ours}.weight"] = (a, b)
    return adapter, factors


def write_weights_root(root: Path, src: dict, scfg, lora_cfg, gen) -> dict:
    """The reference layout under `root` from the source modules (on the
    host): `anysplat.pth` (fp32), `wan_vae/` (fp32),
    `anysplat_stitched.pth`, where `src` holds the generator `umt5/`
    (bf16, HF shards and index), `wan_dit/` (bf16) and the DiT's PEFT
    folder `wan_lora/`, and where `src` holds the scorers'
    towers (`pick_vision`, `pick_text`, `pe_vision`, `pe_text`)
    `pickscore/` (HF CLIP-H with `logit_scale`, `vocab.json` and
    `merges.txt`) and `dfn5b/` (open_clip), each state dict checked
    against its manifest first.  Returns what the checks need: the stitched
    checkpoint's port-named factors and biases, the PEFT adapter, and the
    bytes written."""
    import torch

    from vist3a_tpu_torch.io import manifests

    files = {
        "anysplat_encoder": manifests._fab_anysplat_encoder(src["encoder"]),
        "wan_vae": manifests._fab_wan_vae(src["vae_encoder"],
                                          src["vae_decoder"])}
    if "umt5" in src:
        files["umt5_xxl"] = manifests._fab_umt5(src["umt5"])
    if "dit" in src:
        files["wan_dit"] = manifests._fab_wan_dit(src["dit"])
    if "pick_vision" in src:
        files["pickscore"] = manifests._fab_hf_clip_model(
            src["pick_vision"], src["pick_text"],
            torch.tensor(math.log(PICK_LOGIT_SCALE)))
        files["dfn5b"] = manifests._fab_dfn5b(src["pe_vision"],
                                              src["pe_text"])
    for family, sd in files.items():
        if family == "wan_dit":
            manifests.validate_wan_dit(sd)
        else:
            manifests.validate_state_dict(sd, family)
    ck, factors, biases = stitched_checkpoint(src["encoder"], scfg, lora_cfg,
                                              gen)
    (root / "wan_vae").mkdir(parents=True)
    written = {}
    torch.save(files["anysplat_encoder"], root / "anysplat.pth")
    torch.save(ck, root / "anysplat_stitched.pth")
    written["wan_vae"] = write_safetensors(
        root / "wan_vae" / "diffusion_pytorch_model.safetensors",
        files["wan_vae"])
    adapter, dit_factors = {}, {}
    if "umt5" in src:
        (root / "umt5").mkdir(parents=True)
        written["umt5"] = write_sharded(root / "umt5", files["umt5_xxl"],
                                        CLI_UMT5_SHARDS)
    if "dit" in src:
        adapter, dit_factors = peft_adapter(src["dit"].cfg, gen,
                                           CLI_DIT_LORA_RANK)
        for sub in ("wan_dit", "wan_lora"):
            (root / sub).mkdir(parents=True)
        written["wan_dit"] = write_safetensors(
            root / "wan_dit" / "diffusion_pytorch_model.safetensors",
            files["wan_dit"])
        written["wan_lora"] = write_safetensors(
            root / "wan_lora" / "adapter_model.safetensors", adapter)
    for name in ("anysplat.pth", "anysplat_stitched.pth"):
        written[name] = (root / name).stat().st_size
    for family in ("pickscore", "dfn5b"):
        if family in files:
            (root / family).mkdir()
            written[family] = write_safetensors(
                root / family / "model.safetensors", files[family])
    if "pickscore" in files:
        write_clip_tokenizer(root / "pickscore",
                             (*WORKFLOW_PROMPTS, VDM_CAPTION))
    return {"factors": factors, "biases": biases, "checkpoint": ck,
            "dit_factors": dit_factors, "bytes": written}


def clip_merges(texts) -> list[tuple[str, str]]:
    """A BPE merge list that spells every word of `texts` as one token:
    each word's characters merged left to right, the last one carrying the
    word-final marker."""
    merges, made = [], set()
    for word in " ".join(texts).lower().replace(",", " ").split():
        parts = [*word[:-1], word[-1] + "</w>"]
        cur = parts[0]
        for part in parts[1:]:
            if cur + part not in made:
                merges.append((cur, part))
                made.add(cur + part)
            cur += part
    return merges


def write_clip_tokenizer(folder: Path, texts) -> int:
    """A synthetic HF `vocab.json` + `merges.txt` in the openai order (the
    byte alphabet, its word-final forms, the merges, then the start and
    end tokens, so the end token has the highest id, as CLIP's); returns
    the vocabulary's size, far below CLIP's 49,408."""
    from vist3a_tpu_torch.data.clip_tokenizer import (EOT, SOT,
                                                      bytes_to_unicode)

    merges = clip_merges(texts)
    alphabet = list(bytes_to_unicode().values())
    tokens = [*alphabet, *(c + "</w>" for c in alphabet),
              *("".join(m) for m in merges), SOT, EOT]
    (folder / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(tokens)}), encoding="utf-8")
    (folder / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n",
        encoding="utf-8")
    return len(tokens)


def stage_seconds(since_ns: int) -> dict:
    """{name: [seconds, ...]} of the recorded spans (`core/profiling.span`)
    of phase `cli14b`'s stages (CLI14B_STAGES) that started at or after
    `since_ns` (Unix epoch), in the order they closed."""
    from vist3a_tpu_torch.core.profiling import spans

    out = {}
    for sp in spans():
        if sp.start_ns >= since_ns and sp.name in CLI14B_STAGES:
            out.setdefault(sp.name, []).append(
                (sp.end_ns - sp.start_ns) * 1e-9)
    return out


@contextlib.contextmanager
def timed_calls(module, names: tuple, times: list, sync):
    """Wrap `module.<name>` for each name, appending (name, start, seconds)
    of every call to `times` (after `sync()`); restored on exit."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            times.append((name, t0, time.perf_counter() - t0))
            return out
        return timed
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield times
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


@contextlib.contextmanager
def memory_after(module, names: tuple, out: list, cuda: bool):
    """Wrap `module.<name>` for each name, appending (name, the peak of the
    device memory allocated so far) after every call; restored on exit."""
    import torch

    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def measured(*args, **kwargs):
            res = fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
                out.append((name, torch.cuda.max_memory_allocated()))
            return res
        return measured
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield out
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def expected_stitched(stitched, src: dict, written: dict, lora_cfg,
                      ck: dict) -> dict:
    """What each parameter of the imported stitched decoder must hold,
    computed here from the source encoder and the written factors: the
    source value, or the checkpoint's bias / token / stitch conv, or at a
    LoRA site w + scaling·(a@b)ᵀ in fp32 on the module's device (the
    merge's own formula and operand layouts), each cast to the module's
    dtype."""
    import torch

    enc = {f"encoder.{k}": v for k, v in src["encoder"].state_dict().items()}
    merged = {f"encoder.{s}.weight": f for s, f in written["factors"].items()}
    out = {}
    for name, p in stitched.state_dict().items():
        dev = p.device
        if name.startswith("stitch_conv."):
            want = ck["stitching_layer"][name.split(".", 1)[1]]
        elif name in ("encoder.vit.cls_token", "encoder.vit.register_tokens"):
            want = ck[name.rsplit(".", 1)[1]]
        elif name[len("encoder."):] in written["biases"]:
            want = written["biases"][name[len("encoder."):]]
        elif name in merged:
            f = merged[name]
            w = enc[name].to(dev, torch.float32)
            a = f["a"].T.contiguous().to(dev).T    # lora_Aᵀ, as imported
            b = f["b"].T.contiguous().to(dev).T
            delta = (torch.matmul(a, b) * lora_cfg.scaling).to(w.dtype)
            want = w + delta.T.reshape(w.shape)
        else:
            want = enc[name]
        out[name] = want.to(dev, p.dtype)
    return out


def expected_dit(src_dit, factors: dict, scaling: float,
                 device) -> dict:
    """The DiT's parameters after the PEFT merge, in bf16: w, or at a site
    bf16(w + (B@A)·α/r) computed in fp32 from the written w on `device`,
    where the loader merges (`merged_site`)."""
    import torch

    out = {k: v.detach() for k, v in src_dit.state_dict().items()}
    for name, (a, b) in factors.items():
        out[name] = merged_site(out[name], a, b, scaling, device)
    return {k: v.to(torch.bfloat16) for k, v in out.items()}


def merged_site(w, a, b, scaling: float, device):
    """bf16(w + (B@A)·α/r) from the written w (in the file's dtype) as
    `apply_peft_lora` computes it on `device`: the same operations, so the
    same bits."""
    import torch

    delta = b.to(device, torch.float32) @ a.to(device, torch.float32)
    return (w.to(device).float() + delta * scaling).to(torch.bfloat16)


def near_merge(label: str, got: dict, written: dict, factors: dict,
               scaling: float) -> float:
    """Each PEFT site of `got` (bf16) against w + (B@A)·α/r computed in
    float64 from the written w and factors, apart from the loader's code,
    on `got`'s device: within half a bf16 spacing of that value (the
    rounding of one cast) plus 2⁻²⁰ of |w| + |B|@|A|·α/r (the loader's
    fp32 sum).  A site rounded twice, or merged from other values, lands a
    spacing off.  Returns the largest error as a share of that limit."""
    import torch

    worst = 0.0
    for name, (a, b) in factors.items():
        g = got[name]
        dev = g.device
        w = written[name].to(dev, torch.float64)
        a64, b64 = a.to(dev, torch.float64), b.to(dev, torch.float64)
        x = w + (b64 @ a64) * scaling
        slack = 2.0 ** -20 * (w.abs() + (b64.abs() @ a64.abs()) * scaling)
        # x = m·2^e, m in [½, 1): bf16's spacing there is 2^(e-8)
        spacing = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)
        err = (g.double() - x).abs() / (spacing / 2 + slack)
        worst = max(worst, float(err.max()))
        bad = int((err > 1).sum())
        check(bad == 0, f"{label}: {name}: {bad} values off the float64 "
              f"merge by more than half a bf16 spacing")
    return worst


def same_values(label: str, got: dict, want: dict) -> int:
    """Every tensor of `got` (nested dicts) equal, bit for bit and in dtype,
    to the one at its place in `want`, every other value equal; returns how
    many tensors were compared."""
    import torch

    from vist3a_tpu_torch.io.checkpoints import _flatten

    a, b = _flatten(got), _flatten(want)
    check(a.keys() == b.keys(),
          f"{label}: values {sorted(a.keys() ^ b.keys())[:5]}")
    tensors = [k for k, v in a.items() if isinstance(v, torch.Tensor)]
    bad = [k for k in tensors if not (
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k].to(a[k].device)))]
    bad += [k for k in a if k not in tensors and a[k] != b[k]]
    check(not bad, f"{label}: {len(bad)} values differ, first {bad[:5]}")
    return len(tensors)


def drive_cli(src: dict, scfg, lora_spec: str, tmp: Path, *, tokenize,
              device: str = "cuda", want_launches: dict | None = None,
              prompts=CLI_PROMPTS, flags: tuple = ()) -> dict:
    """Write the reference-format files of the source modules `src` (on the
    host) under `tmp/weights`, run `cli/inference_t23d.py::main` with the
    reference's flags on two prompts, and check what it loaded and wrote.
    Returns the seconds spent writing, reading and importing, each
    request's latency, the peak device memory while loading and while
    serving, and the launches.  `flags`
    are added to the command line (the CPU test's shorter clip)."""
    import torch

    from vist3a_tpu_torch.cli import arguments, inference_t23d, model_loading
    from vist3a_tpu_torch.io import load_weights
    from vist3a_tpu_torch.pipelines import t23d
    from vist3a_tpu_torch.stitch.conv_spec import conv_spec_to_string
    from vist3a_tpu_torch.stitch.lora import parse_lora_mode

    cuda = device == "cuda"
    lora_cfg = parse_lora_mode(lora_spec)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root, out_dir = tmp / "weights", tmp / "results"
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    written = write_weights_root(root, src, scfg, lora_cfg,
                                 torch.Generator().manual_seed(21))
    write_s = time.perf_counter() - t0
    (root / "prompts.txt").write_text("\n".join(prompts) + "\n")
    args = arguments.inference_vist3a_argument().parse_args([
        "--weights_root", str(root),
        "--checkpoint_path", str(root / "anysplat_stitched.pth"),
        "--transformer_lora_path", str(root / "wan_lora"),
        "--input_texts_path", str(root / "prompts.txt"),
        "--output_dir", str(out_dir),
        "--stitching_layer_location", f"enc_blocks_{scfg.stitch_layer_index}",
        "--stitching_layer_config", conv_spec_to_string(scfg.conv),
        "--lora_config", lora_spec, *flags])
    reads, requests, loads = [], [], []
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    loaders = ("load_torch_state_dict", "load_sharded_safetensors")
    serve, load_peak = inference_t23d.run, []

    def peak_then_run(*a, **k):
        # the loading's peak, then the requests' from zero
        if cuda:
            load_peak.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        return serve(*a, **k)
    inference_t23d.run = peak_then_run
    try:
        with timed_calls(load_weights, loaders, reads, sync), \
                timed_calls(t23d, ("text_to_3dgs",), requests, sync), \
                memory_after(model_loading, ("load_stitched_model",), loads,
                             cuda), \
                memory_after(inference_t23d, ("load_generator",), loads,
                             cuda):
            modules, results = inference_t23d.main(args, tokenize,
                                                   device=device)
    finally:
        inference_t23d.run = serve
    sync()
    main_s = time.perf_counter() - t0
    counts = _vdm_counts()
    peak = {"load": load_peak[0], "requests": torch.cuda.max_memory_allocated(),
            **{f"after_{n}": m for n, m in loads}} if cuda else None
    read_s = sum(s for _, _, s in reads)
    load_s = requests[0][1] - t0
    request_s = [s for _, _, s in requests]

    if want_launches is not None:
        got = {k: counts[k] for k in want_launches}
        check(got == want_launches, f"cli: launches {got}, want "
              f"{want_launches}")
    check(sorted(modules) == ["dit", "stitched", "umt5", "vae"],
          f"cli: main built {sorted(modules)} (the decode needs only the "
          "VAE decoder)")
    # what the CLI wrote: one folder per prompt, named as the reference
    # names it
    check([p for p, _ in results] == list(prompts), "cli: prompts run")
    for prompt, summary in results:
        folder = out_dir / prompt[:100].replace("/", "")
        check((folder / "prompt.txt").read_text() == prompt,
              f"cli: {folder}/prompt.txt")
        for f in ("gs.mp4", "depth.mp4", "gaussians.ply"):
            check((folder / f).is_file() and (folder / f).stat().st_size,
                  f"cli: {folder}/{f} missing or empty")
        check(summary["paths"]["ply"] == str(folder / "gaussians.ply"),
              f"cli: paths {summary['paths']}")
        check(summary["latents_finite"], "cli: latents")
        bad = [k for k, ok in summary["finite"].items() if not ok]
        check(not bad, f"cli: non-finite {bad}")
    # what the CLI loaded: the written values, merged where LoRA was
    n_stitched = same_values(
        "stitched decoder", modules["stitched"].state_dict(),
        expected_stitched(modules["stitched"], src, written, lora_cfg,
                          written["checkpoint"]))
    scaling = CLI_DIT_LORA_ALPHA / CLI_DIT_LORA_RANK
    n_dit = same_values("DiT", modules["dit"].state_dict(), expected_dit(
        src["dit"], written["dit_factors"], scaling, device))
    site_err = near_merge("DiT", modules["dit"].state_dict(),
                          src["dit"].state_dict(), written["dit_factors"],
                          scaling)
    n_umt5 = same_values("UMT5", modules["umt5"].state_dict(), {
        k: v.to(torch.bfloat16) for k, v in src["umt5"].state_dict().items()})
    dt = next(modules["vae"].parameters()).dtype
    n_vae = same_values("VAE decoder", modules["vae"].state_dict(), {
        k: v.to(dt) for k, v in src["vae_decoder"].state_dict().items()})
    return {"write_s": write_s, "read_s": read_s,
            "import_s": load_s - read_s, "main_s": main_s,
            "request_s": request_s, "peak_bytes": peak,
            "launches": {k: counts[k] for k in
                         ("unmasked", "masked", "natural", "composite",
                          "qk_prologue")},
            "bytes": written["bytes"],
            "compared": {"stitched": n_stitched, "dit": n_dit,
                         "umt5": n_umt5, "vae_decoder": n_vae},
            "merged_sites": {"stitched": len(written["factors"]),
                             "dit": len(written["dit_factors"])},
            "dit_site_err_share": site_err, "results": results}


def build_cli_sources(generator: bool = True, *, dit: bool = True) -> dict:
    """The modules whose reference-format files phase `cli` writes, drawn on
    the card from a seed and then moved to the host, so the card is free
    for the CLI's own: the whole AnySplat encoder (fp32, with the camera
    trick of `build_stitched`), the Wan 2.1 VAE (fp32), and with
    `generator` UMT5-XXL and (with `dit`) the Wan 2.1 1.3B DiT (bf16)."""
    import torch

    from vist3a_tpu_torch.nn import umt5, wan_dit, wan_vae
    from vist3a_tpu_torch.nn.encoder import Encoder, EncoderConfig
    from vist3a_tpu_torch.nn.layers import build_random

    gen = torch.Generator(device="cuda").manual_seed(31)
    t0 = time.perf_counter()
    src = {"encoder": build_random(
        lambda: Encoder(EncoderConfig(), vit_start=0), gen, "cuda",
        torch.float32)}
    fc2 = src["encoder"].camera_head.pose_branch.fc2
    fc2.weight.mul_(CAMERA_WEIGHT_SCALE)
    fc2.bias.copy_(torch.tensor(CAMERA_BIAS))
    vcfg = wan_vae.WanVAEConfig()
    src["vae_encoder"] = wan_vae.init_encoder(vcfg, gen, device="cuda")
    src["vae_decoder"] = wan_vae.init_decoder(vcfg, gen, device="cuda")
    if generator:
        src["umt5"] = umt5.init(umt5.UMT5_XXL, gen, device="cuda",
                                dtype=torch.bfloat16)
        if dit:
            src["dit"] = wan_dit.init(wan_dit.WAN_1_3B, gen, device="cuda",
                                      dtype=torch.bfloat16)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    src = {k: m.to("cpu") for k, m in src.items()}
    torch.cuda.empty_cache()
    log(f"cli: source modules drawn on the card in {built:.1f} s, moved to "
        f"the host: " + json.dumps(
            {k: sum(p.numel() for p in m.parameters())
             for k, m in src.items()}) + " parameters")
    return src


def keep_scene_folders(results: Path) -> str:
    """Each request folder's prompt.txt and gs.mp4 under `results`, copied
    to a new temporary folder (phase `generation` scores them, then deletes
    it)."""
    keep = Path(tempfile.mkdtemp(prefix="vist3a_scenes_"))
    for d in sorted(results.iterdir()):
        if (d / "gs.mp4").is_file():
            (keep / d.name).mkdir()
            for f in ("prompt.txt", "gs.mp4"):
                shutil.copy2(d / f, keep / d.name / f)
    return str(keep)


def phase_cli(keep_scenes: bool = False, keep_weights: bool = False) -> dict:
    """`cli/inference_t23d.py::main` on full-width reference-format files:
    two prompts through the whole text→3DGS request, the files written from
    seeded modules (`drive_cli`), every check there, the times, the peak
    memory and the launches.  With `keep_scenes`, the requests' prompt.txt
    and gs.mp4 outlive the phase (`keep_scene_folders`); with
    `keep_weights` the weights root does (moved to a new temporary folder,
    `res["weights"]`, for phase `cli14b`)."""
    import torch

    from vist3a_tpu_torch.nn import umt5
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    torch.cuda.empty_cache()
    src = build_cli_sources()
    need = sum(p.numel() * p.element_size() for m in src.values()
               for p in m.parameters())
    tmp = Path(tempfile.mkdtemp(prefix="vist3a_cli_"))
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= CLI_DISK_FACTOR * need,
              f"cli: {free} B free under {tmp}; the files need about "
              f"{need} B (×{CLI_DISK_FACTOR} asked)")
        per_request = {**LAUNCHES_PER_REQUEST, "composite": ORBIT_VIEWS,
                       "natural": 30 * 50, "qk_prologue": 3 * 30 * 50}
        res = drive_cli(src, ca.StitchedConfig(), CLI_LORA_SPEC, tmp,
                        tokenize=fake_tokenizer(umt5.UMT5_XXL),
                        want_launches={k: len(CLI_PROMPTS) * v
                                       for k, v in per_request.items()})
        for prompt, r in res.pop("results"):
            log(f"cli: '{prompt}': {_check_summary(r, GAUSSIANS)}")
        if keep_scenes:
            res["scenes"] = keep_scene_folders(tmp / "results")
        if keep_weights:
            res["weights"] = tempfile.mkdtemp(prefix="vist3a_cli_weights_")
            os.rename(tmp / "weights", Path(res["weights"]) / "weights")
            res["weights"] = str(Path(res["weights"]) / "weights")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del src
        torch.cuda.empty_cache()
    log(f"cli: files written in {res['write_s']:.1f} s "
        f"({json.dumps(res['bytes'])} B; {free} B were free), read in "
        f"{res['read_s']:.1f} s, imported and placed in "
        f"{res['import_s']:.1f} s; requests {res['request_s']} s; main "
        f"{res['main_s']:.1f} s; peak memory allocated (B) "
        f"{json.dumps(res['peak_bytes'])}; launches {res['launches']}; "
        f"every file passed its manifest and every key was consumed "
        f"(`main` raises otherwise); parameters "
        f"equal to what was written {res['compared']} (LoRA-merged sites "
        f"{res['merged_sites']}, off the float64 merge by at most "
        f"{res['dit_site_err_share']:.4f} of half a bf16 spacing and the "
        f"fp32 sum's rounding)")
    return res


def draw_dit_part(cfg, part, device="cuda", dtype=None):
    """Part `part` of a DiT of config `cfg` with random weights drawn on
    `device` in `dtype` (bf16 by default): block `part` (a `WanBlock`)
    from CLI14B_SEED + 1 + part, or for None the DiT without its blocks
    from CLI14B_SEED.  The same values at every call, one part at a time
    on the card."""
    import torch

    from vist3a_tpu_torch.nn import wan_dit
    from vist3a_tpu_torch.nn.layers import build_random

    gen = torch.Generator(device=device).manual_seed(
        CLI14B_SEED + (0 if part is None else 1 + part))
    if part is None:
        return build_random(lambda: wan_dit.WanDiT(
            dataclasses.replace(cfg, num_layers=0)), gen, device,
            dtype or torch.bfloat16)
    return build_random(lambda: wan_dit.WanBlock(cfg), gen, device,
                        dtype or torch.bfloat16)


def _dit_parts(cfg) -> list:
    return [None, *range(cfg.num_layers)]


def _part_prefix(part) -> str:
    return "" if part is None else f"blocks.{part}."


def write_dit_by_parts(folder: Path, cfg, device="cuda", dtype=None) -> int:
    """A diffusers `WanTransformer3DModel` folder of the DiT of config `cfg`
    drawn part by part in `dtype` (`draw_dit_part`): one safetensors
    shard a part, named as diffusers names its shards, and the index.
    Returns the bytes written."""
    from vist3a_tpu_torch.io import manifests

    folder.mkdir(parents=True)
    parts = _dit_parts(cfg)
    weight_map, total = {}, 0
    for i, part in enumerate(parts):
        sd = manifests._fab_wan_dit(
            draw_dit_part(cfg, part, device, dtype), _part_prefix(part))
        shard = (f"diffusion_pytorch_model-{i + 1:05d}-of-"
                 f"{len(parts):05d}.safetensors")
        total += write_safetensors(folder / shard, sd)
        weight_map.update({k: shard for k in sd})
        del sd
    (folder / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total},
                    "weight_map": weight_map}))
    return total


def check_dit_by_parts(dit, factors: dict, scaling: float,
                       device="cuda", dtype=None) -> dict:
    """Every parameter of the loaded DiT equal, bit for bit, to its part
    drawn again from its seed in `dtype` (`draw_dit_part`) on `device`
    and cast to bf16, at a PEFT site to the merge of `merged_site` there,
    and each site near the float64 merge (`near_merge`).  Returns how many
    tensors were compared and the largest site error as a share of
    `near_merge`'s limit."""
    import torch

    n, worst, own = 0, 0.0, dit.state_dict()
    for part in _dit_parts(dit.cfg):
        prefix = _part_prefix(part)
        written = {prefix + k: v for k, v in draw_dit_part(
            dit.cfg, part, device, dtype).state_dict().items()}
        sites = {k: f for k, f in factors.items() if k in written}
        want = {k: (merged_site(v, *sites[k], scaling, device)
                    if k in sites else v.to(torch.bfloat16))
                for k, v in written.items()}
        got = {k: v for k, v in own.items()
               if (k.startswith(prefix) if prefix
                   else not k.startswith("blocks."))}
        n += same_values(f"DiT {prefix or 'outside the blocks'}", got, want)
        worst = max(worst, near_merge(f"DiT {prefix}", got, written, sites,
                                      scaling))
    return {"tensors": n, "site_err_share": worst}


def write_point_anysplat(base: Path, out: Path, point_cfg,
                         device="cuda") -> dict:
    """`base` (an AnySplat state dict) with a VGGT-shaped point head, a
    `DPTHead(point_cfg)` drawn on `device` from CLI14B_POINT_SEED, saved as
    `out`.  Returns the head's values under the port's names, on the
    host."""
    import torch

    from vist3a_tpu_torch.io import load_weights
    from vist3a_tpu_torch.io import weight_import as wi
    from vist3a_tpu_torch.nn.heads import DPTHead
    from vist3a_tpu_torch.nn.layers import build_random

    gen = torch.Generator(device=device).manual_seed(CLI14B_POINT_SEED)
    head = build_random(lambda: DPTHead(point_cfg), gen, device,
                        torch.float32)
    values = {f"point_head.{k}": v.cpu()
              for k, v in head.state_dict().items()}
    sd = load_weights.load_torch_state_dict(base)
    sd.update({"encoder." + wi.encoder_to_reference(k): v
               for k, v in values.items()})
    torch.save(sd, out)
    return values


@contextlib.contextmanager
def peak_rss(out: list):
    """This process's resident set when the block starts and its largest
    while it runs (sampled every 50 ms), appended to `out` as {"start",
    "peak"} in bytes."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page
    start = rss()
    peak, stop = [start], threading.Event()

    def sample():
        while not stop.wait(0.05):
            peak[0] = max(peak[0], rss())
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out.append({"start": start, "peak": max(peak[0], rss())})


def _image_ok(name: str, img, shape=None) -> None:
    """An image of the validation views: finite, of `shape`, not
    constant."""
    import numpy as np

    check(shape is None or tuple(img.shape) == tuple(shape),
          f"{name}: shape {tuple(img.shape)}, want {shape}")
    check(bool(np.isfinite(img).all()), f"{name}: non-finite values")
    check(float(img.max()) > float(img.min()), f"{name}: constant image")


def render_validation(out, folder: Path, *, device="cuda",
                      views: int = CLI14B_VIEWS, image: int = IMAGE,
                      trajectory: int = CLI14B_TRAJECTORY,
                      label: str = "") -> dict:
    """The 3-D validation views of one request's decoder output `out`
    (`viz`): `render_projections` of its Gaussians (their pair counts
    against the render's budget logged), `render_camera_poses` of its
    cameras (white) and 4 views of a trajectory (red), the trajectory
    itself — `interpolate_extrinsics` from the first camera to the last
    with a `generate_wobble_transformation` sway, rendered through
    `render` — and its depth through `apply_color_map_to_image`, laid out
    with `hcat`, `vcat`, `add_label` and `add_border` and written as
    `folder/validation.png`.  Each image checked finite, of its shape and
    not constant; on the card the drawing and the colour map also against
    the host CPU.  Each stage is a span (`core/profiling.span`) named
    `viz.*`."""
    import numpy as np
    import torch

    from vist3a_tpu_torch import viz
    from vist3a_tpu_torch.core.profiling import span
    from vist3a_tpu_torch.eval.nvs import save_image
    from vist3a_tpu_torch.kernels import rasterizer as tr
    from vist3a_tpu_torch.nn.splat_decoder import render
    from vist3a_tpu_torch.viz.validation_in_3d import projection_cameras

    g = out.gaussians
    n_gauss = g.means.shape[1]
    res = {}
    with span("viz.projections"):
        proj = viz.render_projections(g, views, extra_label=label,
                                      device=device)
    _image_ok("projections", proj)
    check(proj.shape[:3] == (1, 3, 3) and proj.shape[3] > views
          and proj.shape[4] >= views, f"projections {proj.shape}")
    budget = tr.default_pair_budget(n_gauss)
    pairs = []
    with torch.inference_mode():
        for c2w, k, name in projection_cameras(g):
            viewmat = torch.linalg.inv(torch.from_numpy(
                c2w[0].astype(np.float32)).to(device))
            kk = torch.from_numpy(k[0].astype(np.float32)).to(device) \
                * torch.tensor([[views], [views], [1.0]], device=device)
            _, p = tr.view_pairs(g.means[0], g.covariances[0],
                                 g.harmonics[0], g.opacities[0], viewmat,
                                 kk, views, views, budget)
            pairs.append({"view": name, "pairs": p.total,
                          "cut": max(0, p.total - budget)})
    res["projection_pairs"] = {"budget": budget, "views": pairs}
    log(f"cli14b: render_projections at {views}²: pairs per view against "
        f"the budget {budget} (default_pair_budget({n_gauss})) "
        + json.dumps(pairs))

    ex = out.extrinsic_c2w[0].float().cpu().numpy().astype(np.float64)
    kn = out.intrinsic_norm[0].float().cpu().numpy().astype(np.float64)
    t = np.linspace(0.0, 1.0, trajectory)
    with span("viz.trajectory"):
        radius = np.asarray(CLI14B_WOBBLE * float(out.scene_scale))
        traj = viz.interpolate_extrinsics(ex[0], ex[-1], t) \
            @ viz.generate_wobble_transformation(radius, t)
        traj_k = viz.interpolate_intrinsics(kn[0], kn[-1], t)
        with torch.inference_mode():
            r = render(g, torch.from_numpy(traj)[None],
                       torch.from_numpy(traj_k)[None], (image, image),
                       device=device)
        frames = r.color[0].cpu().numpy()
    _image_ok("trajectory", frames, (trajectory, 3, image, image))
    with span("viz.color_map"):
        depth, alpha = r.depth[0], r.alpha[0]
        # the depth range of the covered pixels (`torch.quantile` takes at
        # most 2²⁴ values, so every k-th)
        seen = depth[alpha > 0.5]
        lo, hi = ((torch.quantile(seen[::max(1, seen.numel() >> 22)],
                                  torch.tensor([0.01, 0.99], device=device))
                   .tolist()) if seen.numel() else (0.0, 1.0))
        depth01 = ((depth - lo) / max(hi - lo, 1e-12)).clamp(0, 1)
        colored = viz.apply_color_map_to_image(depth01)
        if torch.device(device).type == "cuda":
            host = viz.apply_color_map_to_image(depth01.cpu().numpy())
            check(np.array_equal(colored.cpu().numpy(), host),
                  "apply_color_map: card and host CPU differ")
        colored = colored.cpu().numpy()
    _image_ok("depth colours", colored, (trajectory, 3, image, image))

    shown = np.linspace(0, trajectory - 1, CLI14B_TRAJECTORY_SHOWN) \
        .round().astype(int)
    near, far = torch.quantile(
        out.depth.flatten()[::max(1, out.depth.numel() >> 22)].float(),
        torch.tensor([0.05, 0.5], device=out.depth.device)).tolist()
    s = ex.shape[0]
    batch = {"context": {"extrinsics": ex[None], "intrinsics": kn[None],
                         "near": np.full((1, s), near),
                         "far": np.full((1, s), far)},
             "target": {"extrinsics": traj[None, shown].astype(np.float64),
                        "intrinsics": traj_k[None, shown].astype(np.float64),
                        "near": np.full((1, len(shown)), near),
                        "far": np.full((1, len(shown)), far)}}
    with span("viz.camera_poses"):
        poses = viz.render_camera_poses(batch, views, device=device)
    _image_ok("camera poses", poses)
    check(poses.shape[:2] == (3, 3) and poses.shape[3] >= views,
          f"camera poses {poses.shape}")
    if torch.device(device).type == "cuda":
        with span("viz.camera_poses_host"):
            host = viz.render_camera_poses(batch, views, device="cpu")
        res["poses_card_vs_host"] = float(np.abs(poses - host).max())
        limit = CLI14B_DRAW_ROUNDINGS * views * 2.0 ** -24
        check(res["poses_card_vs_host"] <= limit,
              f"render_camera_poses: card and host CPU differ by "
              f"{res['poses_card_vs_host']} (limit {limit})")

    with span("viz.layout"):
        rows = [viz.hcat(*proj[0]), viz.hcat(*poses),
                viz.hcat(*(viz.vcat(viz.add_label(frames[i], f"view {i}"),
                                    colored[i]) for i in shown))]
        sheet = viz.add_border(viz.vcat(*rows, align="left", gap=16))
        png = folder / "validation.png"
        save_image(sheet, png)
    _image_ok("validation sheet", sheet)
    check(png.is_file() and png.stat().st_size > 0, f"{png} not written")
    res.update({"projections": list(proj.shape), "poses": list(poses.shape),
                "trajectory": list(frames.shape),
                "sheet": list(sheet.shape), "png_bytes": png.stat().st_size,
                "near_far": [near, far], "wobble_radius": float(radius)})
    return res


def drive_cli14b(base: Path, tmp: Path, scfg, *, tokenize, device="cuda",
                 steps: int = CLI14B_STEPS, point_cfg=None,
                 viz_sizes: dict | None = None, flags: tuple = (),
                 dit_dir: Path | None = None, dit_dtype=None) -> dict:
    """Phase `cli14b`'s request on files.  Under `tmp/weights`: the DiT of
    CLI14B_MODEL_ID in diffusers shards drawn part by part in `dit_dtype`
    (bf16 by default; `write_dit_by_parts`), a PEFT adapter r8 α16 on its
    q/k/v/o, `anysplat.pth` = `base`'s with a VGGT-shaped point head
    (`write_point_anysplat`; `point_cfg`, by default `EncoderConfig().point`)
    and links to `base`'s `wan_vae/`, `umt5/` and stitched checkpoint (phase
    `cli`'s files).  Then the command line's loaders and request —
    `load_stitched_model`, `load_generator`, `inference_t23d.run` on
    CLI14B_PROMPT at `steps` UniPC steps — with the DiT checked bit for bit
    part by part (`check_dit_by_parts`) and the validation views of the
    request's output (`render_validation`, `viz_sizes` its sizes).  The
    stitched checkpoint is of `scfg`'s chop and conv; `flags` are added to
    the command line; with `dit_dir` the DiT's folder is written there and
    linked as `wan_dit/`.  Returns the seconds of its stages' spans
    (`times`), the bytes, the host's resident set while the generator
    loaded, the seconds of the loader's calls and of the request's stages,
    the launches of the request and the views, the run's summary, and what
    the point-head decode needs (`args`, the head's values)."""
    import torch

    from vist3a_tpu_torch.cli import arguments, inference_t23d, model_loading
    from vist3a_tpu_torch.core.profiling import span
    from vist3a_tpu_torch.io import load_weights, manifests
    from vist3a_tpu_torch.io import weight_import as wi
    from vist3a_tpu_torch.nn import wan_dit
    from vist3a_tpu_torch.nn.encoder import EncoderConfig
    from vist3a_tpu_torch.pipelines import t23d
    from vist3a_tpu_torch.stitch.conv_spec import conv_spec_to_string

    cuda = torch.device(device).type == "cuda"
    since = time.time_ns()
    root, out_dir = tmp / "weights", tmp / "results"
    root.mkdir(parents=True)
    model_id, prompt = CLI14B_MODEL_ID, CLI14B_PROMPT
    dit_cfg = wan_dit.config_from_model_id(model_id)
    written = {}
    with span("write.dit"):
        folder = root / "wan_dit" if dit_dir is None else dit_dir / "wan_dit"
        written["wan_dit"] = write_dit_by_parts(folder, dit_cfg, device,
                                                dit_dtype)
        if dit_dir is not None:
            (root / "wan_dit").symlink_to(folder)
    with span("write.other"):
        adapter, factors = peft_adapter(dit_cfg,
                                        torch.Generator().manual_seed(22),
                                        CLI_DIT_LORA_RANK)
        (root / "wan_lora").mkdir()
        written["wan_lora"] = write_safetensors(
            root / "wan_lora" / "adapter_model.safetensors", adapter)
        point = write_point_anysplat(
            base / "anysplat.pth", root / "anysplat.pth",
            point_cfg or EncoderConfig().point, device)
        written["anysplat.pth"] = (root / "anysplat.pth").stat().st_size
        for name in ("wan_vae", "umt5", "anysplat_stitched.pth"):
            (root / name).symlink_to((base / name).resolve())
    (root / "prompts.txt").write_text(prompt + "\n")
    args = arguments.inference_vist3a_argument().parse_args([
        "--weights_root", str(root),
        "--checkpoint_path", str(root / "anysplat_stitched.pth"),
        "--transformer_lora_path", str(root / "wan_lora"),
        "--input_texts_path", str(root / "prompts.txt"),
        "--output_dir", str(out_dir), "--model_id", model_id,
        "--stitching_layer_location", f"enc_blocks_{scfg.stitch_layer_index}",
        "--stitching_layer_config", conv_spec_to_string(scfg.conv),
        "--lora_config", CLI_LORA_SPEC, *flags])

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rss, calls = [], []
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with span("load.stitched"):
        modules, loaded = model_loading.load_stitched_model(args,
                                                            device=device)
    with span("load.generator"), peak_rss(rss), \
            timed_calls(load_weights, ("load_sharded_safetensors",), calls,
                        sync), \
            timed_calls(manifests, ("validate_state_dict",), calls, sync), \
            timed_calls(wi, ("import_umt5", "import_wan_dit",
                             "apply_peft_lora", "build_module"), calls,
                        sync):
        modules.update(inference_t23d.load_generator(
            root, model_id, args.transformer_lora_path, device=device))
    load_calls = {}
    for name, _, x in calls:
        load_calls.setdefault(name, []).append(round(x, 2))
    load_peak = torch.cuda.max_memory_allocated() if cuda else None
    check(modules["dit"].cfg == dit_cfg, f"the DiT loaded as "
          f"{modules['dit'].cfg}, want {dit_cfg}")
    log(f"cli14b: files written and loaded, seconds so far "
        + json.dumps({k: round(v[0], 1)
                      for k, v in stage_seconds(since).items()})
        + f"; load_generator's calls (s) {json.dumps(load_calls)}")
    cfg = inference_t23d.request_config(args, dit_cfg, loaded,
                                        num_inference_steps=steps)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    store, stages = {}, []
    _reset_counts()
    with span("request"), captured(t23d, "text_to_3dgs", store), \
            timed_calls(t23d, T23D_REQUEST_STAGES, stages, sync):
        results = inference_t23d.run(modules, tokenize, [prompt],
                                     str(out_dir), cfg, device=device)
    request_peak = torch.cuda.max_memory_allocated() if cuda else None
    stage_s = {name: s for name, _, s in stages}
    result = store["text_to_3dgs"][2]
    log(f"cli14b: request {stage_seconds(since)['request'][0]:.1f} s, "
        f"stages (s) {json.dumps({n: round(x, 2) for n, _, x in stages})}")
    folder = out_dir / prompt[:100].replace("/", "")
    check([p for p, _ in results] == [prompt], "cli14b: prompts run")
    check((folder / "prompt.txt").read_text() == prompt,
          f"cli14b: {folder}/prompt.txt")
    views = render_validation(result.output, folder, device=device,
                              label="(14B)", **(viz_sizes or {}))
    launches = _vdm_counts()
    if cuda:
        # one DiT forward a step (the CFG pair batched), 3 a block
        want = {"natural": dit_cfg.num_layers * steps,
                "qk_prologue": 3 * dit_cfg.num_layers * steps}
        got = {k: launches[k] for k in want}
        check(got == want, f"cli14b: request launches {got}, want {want}")
    with span("check.dit"):
        dit_check = check_dit_by_parts(
            modules["dit"], factors, CLI_DIT_LORA_ALPHA / CLI_DIT_LORA_RANK,
            device, dit_dtype)
    del modules, result, store
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"times": stage_seconds(since), "bytes": written,
            "peak_bytes": {"load": load_peak, "request": request_peak},
            "host_rss_load_generator": rss[0],
            "launches": {k: launches[k] for k in
                         ("unmasked", "masked", "natural", "composite",
                          "qk_prologue")},
            "compared": {"dit": dit_check["tensors"]},
            "merged_sites": len(factors),
            "dit_site_err_share": dit_check["site_err_share"],
            "stages_s": stage_s, "steps": steps, "load_calls": load_calls,
            "results": results, "views": views, "args": args,
            "point": point}


def drive_point_decode(args, point: dict, *, device="cuda",
                       frames: int = 13, image: int = IMAGE,
                       latent_hw: int = 64) -> dict:
    """The stitched decoder with the AnySplat file's point head
    (`load_stitched_model` on phase `cli14b`'s files, its config's encoder
    taking the point branch): its point head equal, bit for bit, to
    `point` (what was written), then one decode through
    `forward_with_latent` of a random latent and images (bf16 cascades, as
    the inference decode): the depth is the points' z, bit for bit, and
    the confidence above 1.  Returns the launches and a summary."""
    import torch

    from vist3a_tpu_torch.cli import model_loading
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    cuda = torch.device(device).type == "cuda"
    depth_config = model_loading.stitched_config

    def point_config(a):
        scfg = depth_config(a)
        return dataclasses.replace(scfg, encoder=dataclasses.replace(
            scfg.encoder, pred_head_type="point"))
    t0 = time.perf_counter()
    model_loading.stitched_config = point_config
    try:
        modules, scfg = model_loading.load_stitched_model(args,
                                                          device=device)
    finally:
        model_loading.stitched_config = depth_config
    load_s = time.perf_counter() - t0
    model = modules["stitched"]
    n_point = same_values("point head", {
        k: v for k, v in model.encoder.state_dict().items()
        if k.startswith("point_head.")}, point)
    scfg = dataclasses.replace(scfg, encoder=dataclasses.replace(
        scfg.encoder, head_dtype="bfloat16"))
    gen = torch.Generator().manual_seed(CLI14B_POINT_SEED + 1)
    t_lat = (frames - 1) // 4 + 1
    latent = torch.randn(1, 16, t_lat, latent_hw, latent_hw,
                         generator=gen).to(torch.bfloat16)
    images = (torch.rand(1, 3, frames, image, image, generator=gen) * 2
              - 1).to(torch.bfloat16)
    if cuda:
        torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = ca.forward_with_latent(model, latent, images, scfg,
                                     device=device)
    if cuda:
        torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = _vdm_counts()
    g = frames * image * image
    check(tuple(out.gaussians.means.shape) == (1, g, 3)
          and tuple(out.depth.shape) == (1, frames, image, image, 1),
          f"point decode: means {tuple(out.gaussians.means.shape)}, depth "
          f"{tuple(out.depth.shape)}")
    check(torch.equal(out.depth.reshape(-1),
                      out.gaussians.means[..., 2].reshape(-1)),
          "point decode: the depth is not the points' z")
    check(float(out.depth_conf.min()) > 1.0,
          "point decode: a confidence ≤ 1 (expp1)")
    for name, x in (("means", out.gaussians.means),
                    ("opacities", out.gaussians.opacities),
                    ("depth_conf", out.depth_conf),
                    ("extrinsic_c2w", out.extrinsic_c2w)):
        check(bool(torch.isfinite(x).all()), f"point decode: non-finite "
              f"{name}")
    summary = {"load_s": load_s, "decode_s": decode_s,
               "point_head_tensors": n_point,
               "means_range": [float(out.gaussians.means.min()),
                               float(out.gaussians.means.max())],
               "live": int((out.gaussians.opacities > 0).sum())}
    return {"launches": {k: launches[k] for k in (
        "unmasked", "masked", "natural", "composite", "qk_prologue")},
            "summary": summary}


def block_check_14b(cfg) -> dict:
    """Block 0 of the 14B DiT (`draw_dit_part`, the values of the written
    file) at the full token count — x (2, 4096, 5120), 226 text tokens,
    the (4, 32, 32) grid's RoPE — on the card twice, bf16 weights and
    activations (the kernel route at head_dim 128 is bf16): through the
    attention dispatch (row 3, one launch) and with its self-attention on
    `ops/attention.py::plain_attention`.  Two comparisons, in fp32, each
    within 2⁻⁵ of the plain one's range (the limit of `reference_dit`):
    the self-attention's output, the kernel's against `plain_attention`
    on the same q, k, v (those the dispatch was given in the block), and
    the block's output.  The block's output sees attention only through
    its gate (0.1·N(0, 1) here) and is dominated by the residual, so the
    first is the check that holds row 3."""
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.nn import wan_dit
    from vist3a_tpu_torch.ops.attention import plain_attention

    blk = draw_dit_part(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(CLI14B_SEED - 1)
    x = torch.randn(2, 4096, cfg.dim, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    text = torch.randn(2, 226, cfg.dim, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    temb6 = 0.1 * torch.randn(2, 6, cfg.dim, generator=gen, device="cuda")
    rope = tuple(t.cuda() for t in wan_dit.rope_tables(cfg, 4, 32, 32))
    store = {}
    with torch.inference_mode():
        before = fa.launches_natural
        with captured(wan_dit, "dot_product_attention", store, first=True):
            out = blk(x, text, temb6, rope).float()
        launched = fa.launches_natural - before
        (q, k, v), kw, attn = store["dot_product_attention"]
        attn_ref = plain_attention(q, k, v).float()
        dispatch = wan_dit.dot_product_attention
        wan_dit.dot_product_attention = \
            lambda q, k, v, impl="auto": plain_attention(q, k, v)
        try:
            ref = blk(x, text, temb6, rope).float()
        finally:
            wan_dit.dot_product_attention = dispatch
    check(launched == 1, f"14B block: {launched} natural launches, want 1")
    check(kw.get("impl", "auto") == "auto" and tuple(q.shape) == (
        2, 4096, cfg.num_heads, cfg.head_dim), f"14B block: the first "
        f"attention call is not the self-attention: {tuple(q.shape)} {kw}")
    errs = {}
    for name, got, want in (("attention", attn.float(), attn_ref),
                            ("block", out, ref)):
        check(bool(torch.isfinite(got).all()), f"14B block: non-finite "
              f"{name} output")
        diff = (got - want).abs()
        errs[name] = {"max": (diff.max() / want.abs().max()).item(),
                      "mean": (diff.mean() / want.abs().mean()).item()}
    log(f"cli14b: one 14B block (dim {cfg.dim}, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, 4096 tokens), kernel route vs plain_attention on "
        f"the card, max |Δ| / max |ref| and mean |Δ| / mean |ref|: "
        f"{json.dumps(errs)}, natural launches {launched}")
    for name, e in errs.items():
        check(e["max"] <= 2 ** -5, f"14B block: the kernel route and plain "
              f"attention disagree on the {name} output {e}")
    return errs


def _mem_available() -> int:
    """The host's available memory (/proc/meminfo), in bytes."""
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) * 1024


def shard_parent() -> Path:
    """Where phase `cli14b` writes the 14B DiT's shards: $VIST3A_SHARD_DIR,
    else /dev/shm where it is writable (memory-backed), else the temporary
    folder."""
    if os.environ.get("VIST3A_SHARD_DIR"):
        return Path(os.environ["VIST3A_SHARD_DIR"])
    shm = Path("/dev/shm")
    if shm.is_dir() and os.access(shm, os.W_OK):
        return shm
    return Path(tempfile.gettempdir())


def sweep_stale_shards(parent: Path) -> list[str]:
    """Remove the folders under `parent` that phase `cli14b` wrote
    (CLI14B_SHARD_PREFIX<pid>_…, this user's) whose process has ended: a
    run killed before its `finally` leaves 28.6 GB of shards, in memory
    where the parent is /dev/shm.  Returns the names removed."""
    gone = []
    for d in parent.glob(CLI14B_SHARD_PREFIX + "*"):
        pid = d.name[len(CLI14B_SHARD_PREFIX):].split("_", 1)[0]
        if not pid.isdigit() or d.stat().st_uid != os.getuid():
            continue
        try:
            os.kill(int(pid), 0)
            continue
        except ProcessLookupError:
            pass
        except PermissionError:
            continue
        shutil.rmtree(d, ignore_errors=True)
        gone.append(d.name)
    return gone


def _exit_on_term(signum, frame):
    raise SystemExit(128 + signum)


def phase_cli14b(base: str | None = None) -> dict:
    """VIST3A-14B from its command line (`drive_cli14b`) on phase `cli`'s
    files (`base`, deleted after) or, run alone, on files this phase writes
    from the sources of phase `cli` without the 1.3B DiT; then the 14B
    block check (`block_check_14b`) and the point-head decode
    (`drive_point_decode`) with its narrow card-vs-host reference.  The
    14B DiT's 28.6 GB of shards go to a memory-backed folder
    (`shard_parent`), so that the disk, which holds phase `cli`'s files
    meanwhile, takes that much less writing in a run; the stale shards of
    a killed run are removed first, and a SIGTERM runs the cleanup."""
    import torch

    from vist3a_tpu_torch.io import weight_import as wi
    from vist3a_tpu_torch.nn import umt5, wan_dit
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca
    from vist3a_tpu_torch.stitch.lora import parse_lora_mode

    torch.cuda.empty_cache()
    parent = shard_parent()
    swept = sweep_stale_shards(parent)
    if swept:
        log(f"cli14b: removed the shards of ended runs under {parent}: "
            f"{swept}")
    term = signal.signal(signal.SIGTERM, _exit_on_term)
    tmp = Path(tempfile.mkdtemp(prefix="vist3a_cli14b_"))
    shm = Path(tempfile.mkdtemp(
        prefix=f"{CLI14B_SHARD_PREFIX}{os.getpid()}_", dir=parent))
    cfg = wan_dit.config_from_model_id(CLI14B_MODEL_ID)
    n_dit = sum(p.numel() for p in wi.on_meta(
        lambda: wan_dit.WanDiT(cfg)).parameters())
    try:
        if base is not None:
            # phase `cli`'s 1.3B DiT, which this phase does not read: its
            # pages may be held in the host's memory
            shutil.rmtree(Path(base) / "wan_dit")
        ram = _mem_available()
        check(ram >= CLI14B_RAM_FACTOR * 2 * n_dit,
              f"cli14b: {ram} B of host memory available; the DiT's shards "
              f"and their load need about {CLI14B_RAM_FACTOR} × {2 * n_dit}"
              f" B")
        if base is None:
            src = build_cli_sources(dit=False)
            base_bytes = sum(p.numel() * p.element_size()
                             for m in src.values() for p in m.parameters())
            encoder_bytes = sum(p.numel() * p.element_size()
                                for p in src["encoder"].parameters())
        else:
            base_bytes = 0
            encoder_bytes = (Path(base) / "anysplat.pth").stat().st_size
        # `anysplat.pth` again with its point head, and the DiT where its
        # shards share the disk
        need = encoder_bytes + base_bytes + CLI14B_EXTRA_BYTES + (
            2 * n_dit if shm.stat().st_dev == tmp.stat().st_dev else 0)
        free = shutil.disk_usage(tmp).free
        check(free >= CLI_DISK_FACTOR * need,
              f"cli14b: {free} B free under {tmp}; the files need about "
              f"{need} B (×{CLI_DISK_FACTOR} asked)")
        if base is None:
            t0 = time.perf_counter()
            (tmp / "base").mkdir()
            write_weights_root(tmp / "base", src, ca.StitchedConfig(),
                               parse_lora_mode(CLI_LORA_SPEC),
                               torch.Generator().manual_seed(21))
            del src
            log(f"cli14b: run alone, phase cli's files without the 1.3B DiT "
                f"written in {time.perf_counter() - t0:.1f} s")
            base = str(tmp / "base")
        res = drive_cli14b(Path(base), tmp, ca.StitchedConfig(),
                           tokenize=fake_tokenizer(umt5.UMT5_XXL),
                           dit_dir=shm)
        res["ram_available"] = ram
        (prompt, summary), = res.pop("results")
        log(f"cli14b: '{prompt}': {_check_summary(summary, GAUSSIANS)}")
        res["block"] = block_check_14b(cfg)
        point = drive_point_decode(res.pop("args"), res.pop("point"))
        res["point"] = point
        res["point_reference"] = narrow_decoder_errors(
            narrow_config("point"), "cli14b point head")
    finally:
        shutil.rmtree(shm, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)
        if base is not None:
            shutil.rmtree(base, ignore_errors=True)
        signal.signal(signal.SIGTERM, term)
        torch.cuda.empty_cache()
    memory = {f"cuda:{i}": {
        "bytes_in_use": torch.cuda.memory_allocated(i),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
        for i in range(torch.cuda.device_count())}
    stages, steps = res["stages_s"], res["steps"]
    ms_step = 1e3 * stages["denoise"] / steps
    rest = res["times"]["request"][0] - stages["denoise"]
    res["ms_per_step"] = ms_step
    log(f"cli14b: stage spans (s) {json.dumps(res['times'])}; "
        f"memory {json.dumps(memory)}")
    log(f"cli14b: VIST3A-14B, {n_dit} DiT parameters ({res['compared']['dit']}"
        f" tensors equal to what was written, {res['merged_sites']} PEFT "
        f"sites merged, off the float64 merge by at most "
        f"{res['dit_site_err_share']:.4f} of half a bf16 spacing and the "
        f"fp32 sum's rounding): files "
        f"{json.dumps(res['bytes'])} B; host "
        f"resident set while load_generator ran (B) "
        f"{json.dumps(res['host_rss_load_generator'])}; peak memory "
        f"allocated (B) "
        f"{json.dumps(res['peak_bytes'])}; request stages (s) "
        f"{json.dumps(stages)}: {steps} UniPC steps (deployed 50) at "
        f"{ms_step:.1f} ms a step, so a 50-step request "
        f"{50 * ms_step / 1e3 + rest:.1f} s; launches {res['launches']}; "
        f"views {json.dumps(res['views'])}")
    log(f"cli14b: point-head decode {json.dumps(point['summary'])}, launches "
        f"{point['launches']}")
    return res


def build_trainer(cfg):
    """The distillation teacher (the full encoder, ~1.19 B parameters), a
    stitch conv and the Wan 2.1 VAE encoder, fp32, random weights drawn on
    the card from a seeded generator; the teacher's camera head as the
    stitched decoder's (`build_stitched`), which the student shares."""
    import torch

    from vist3a_tpu_torch.nn import wan_vae
    from vist3a_tpu_torch.nn.encoder import Encoder
    from vist3a_tpu_torch.nn.layers import build_random
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.perf_counter()
    teacher = build_random(lambda: Encoder(cfg.encoder, vit_start=0), gen,
                           "cuda", torch.float32)
    fc2 = teacher.camera_head.pose_branch.fc2
    fc2.weight.mul_(CAMERA_WEIGHT_SCALE)
    fc2.bias.copy_(torch.tensor(CAMERA_BIAS))
    stitch_conv = build_random(lambda: ca.init_stitch_conv(cfg), gen, "cuda",
                               torch.float32)
    vae = wan_vae.init_encoder(wan_vae.WanVAEConfig(), gen, device="cuda")
    torch.cuda.synchronize()
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    log(f"train: teacher EncoderConfig() with the whole ViT, "
        f"{count(teacher)} parameters (fp32); stitch conv "
        f"{count(stitch_conv)}; Wan VAE encoder {count(vae)}; built on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    return teacher, stitch_conv, vae


def train_seed() -> int:
    """The smallest seed whose view-count draws for steps 0 and 1 are
    `TRAIN_VIEWS` (13, then the largest, 21, which sets the peak memory)."""
    from vist3a_tpu_torch.train import stitching as st

    return next(s for s in range(1 << 16)
                if [st.sample_view_count(s, i) for i in range(2)]
                == list(TRAIN_VIEWS))


def _train_counts(fa) -> dict:
    return {"unmasked": fa.launches_unmasked, "masked": fa.launches_masked,
            "natural": fa.launches_natural, "backward": fa.launches_backward}


def phase_train() -> dict:
    """Two full-width fp32 distillation steps through `run` (S = 13, then
    21), their checks, launch counts, times and peak memory, then one more
    step at S = 13 under the profiler, then a narrow step card vs host."""
    import torch

    from vist3a_tpu_torch.cli import train_stitching as cli
    from vist3a_tpu_torch.io import checkpoints as ckpt
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.pipelines import t23d
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca
    from vist3a_tpu_torch.train import stitching as st

    log(f"train: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32} (the JAX step's fp32)")
    cfg = ca.StitchedConfig()
    torch.cuda.empty_cache()
    teacher, stitch_conv, vae = build_trainer(cfg)
    gen = torch.Generator(device="cuda").manual_seed(10)
    clip = torch.rand(TRAIN_CLIP, generator=gen, device="cuda") * 2 - 1
    feedforward = t23d.resize_trilinear_half_pixel(clip, (IMAGE, IMAGE))
    batch = {"vae_image_tensor": clip,
             "feedforward_image_tensor": feedforward}
    seed = train_seed()
    tcfg = st.StitchTrainConfig(lora_spec=TRAIN_LORA, warmup_steps=1,
                                total_steps=10)
    sums_before = [p.double().sum().item() for p in teacher.parameters()]
    marks = []

    def on_metrics(m):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _train_counts(fa),
                      torch.cuda.max_memory_allocated(), m))
        torch.cuda.reset_peak_memory_stats()

    ckpt_dir = Path(tempfile.mkdtemp(prefix="vist3a_train_ckpt_"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = cli.run(
        {"encoder": teacher, "stitch_conv": stitch_conv, "vae": vae}, cfg,
        [batch, batch], train_cfg=tcfg, num_epochs=1, seed=seed, log_every=1,
        on_metrics=on_metrics, save_path=ckpt_dir)
    saved_s = time.perf_counter() - marks[-1][0]
    counts = _train_counts(fa)
    n_train = sum(p.numel() for p in st.trainable_list(state.trainable))
    log(f"train: seed {seed}, LoRA {TRAIN_LORA}, {n_train} trainable "
        f"parameters ({len(state.trainable['lora'])} LoRA sites)")
    check([h["views"] for h in history] == list(TRAIN_VIEWS),
          f"view counts {[h['views'] for h in history]}")
    steps_ms, peaks, prev, prev_t = [], [], {k: 0 for k in counts}, t0
    for i, (tm, c, peak, m) in enumerate(marks):
        grew = {k: c[k] - prev[k] for k in c}
        steps_ms.append((tm - prev_t) * 1e3)
        peaks.append(peak)
        prev, prev_t = c, tm
        bad = {k: v for k, v in m.items() if not math.isfinite(v)}
        check(not bad, f"step {i}: non-finite metrics {bad}")
        check(m["grad_norm"] > 0, f"step {i}: grad_norm {m['grad_norm']}")
        check(grew == TRAIN_LAUNCHES,
              f"step {i}: launches {grew}, want {TRAIN_LAUNCHES}")
        log(f"train: step {i} (S = {m['views']}): {steps_ms[-1]:.1f} ms, "
            f"peak memory allocated {peak} B, launches {grew}, lr "
            f"{m['lr']:.6g}, grad_norm {m['grad_norm']:.6g}, total_loss "
            f"{m['total_loss']:.6g}")
        log(f"train: step {i} loss terms " + json.dumps(
            {k: v for k, v in m.items() if "loss" in k}))
    check(history[0]["lr"] == 0 and history[1]["lr"] > 0,
          f"lr {[h['lr'] for h in history]}")
    b_max = [f["b"].abs().max().item()
             for f in state.trainable["lora"].values()]
    check(min(b_max) > 0, f"{sum(b == 0 for b in b_max)} LoRA B factors "
          "never moved after the step with lr > 0")
    sums_after = [p.double().sum().item() for p in teacher.parameters()]
    check(sums_after == sums_before, "the teacher's weights changed")
    own = {f"encoder.{n}": p for n, p in teacher.named_parameters()}
    _, frozen = st.split_params(teacher, None, cfg, tcfg.lora)
    check(bool(frozen) and all(t.data_ptr() == own[n].data_ptr()
                               for n, t in frozen.items()),
          "the student's frozen tensors are not the teacher's")
    check(all(p.data_ptr() != own[n].data_ptr()
              for n, p in state.trainable["model"].items() if n in own),
          "a trainable shares the teacher's storage")
    log(f"train: teacher weights unchanged ({len(sums_before)} checksums), "
        f"{len(frozen)} frozen student tensors are the teacher's own; "
        f"LoRA B factors moved (smallest max |B| {min(b_max):.3g})")
    log(f"train: ms per step {steps_ms}; peak memory allocated {peaks} B; "
        f"launches {counts}")
    # the epoch's save (`save_path`), reloaded into a fresh state: no step
    try:
        t1 = time.perf_counter()
        fresh, _ = st.init_train_state(
            torch.Generator(device="cuda").manual_seed(11), teacher,
            stitch_conv, cfg, tcfg)
        epoch, fresh = ckpt.load_stitching_checkpoint(ckpt_dir, fresh)
        n = same_values("train: reloaded", {
            "trainable": state.trainable,
            "optimizer": state.optimizer.state_dict()["state"]}, {
            "trainable": fresh.trainable,
            "optimizer": fresh.optimizer.state_dict()["state"]})
        check(epoch == 1 and fresh.step == state.step == len(TRAIN_VIEWS),
              f"train: reloaded epoch {epoch}, step {fresh.step}")
        files = {p.name: p.stat().st_size for p in ckpt_dir.iterdir()}
        log(f"train: saved {files} B after the epoch ({saved_s:.1f} s), "
            f"reloaded into a fresh state in {time.perf_counter() - t1:.1f} "
            f"s: {n} tensors (trainables, AdamW moments) equal bit for bit")
        del fresh
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    latent = cli.encode_context(vae, clip[:, :, :TRAIN_VIEWS[0]], gen)
    ff = feedforward[:, :, :TRAIN_VIEWS[0]]
    teacher01 = ((ff + 1.0) * 0.5).transpose(1, 2)
    profile_call("train_step_s13", lambda: st.stitch_train_step(
        state, teacher, latent, ff, teacher01, cfg, tcfg))
    del state, frozen, teacher, vae, latent
    torch.cuda.empty_cache()
    return {"ms_per_step": steps_ms, "peak_bytes": peaks, "launches": counts,
            "reference": train_reference()}


def train_reference() -> dict:
    """One narrow training step (`narrow_config()`: full spatial shape, 5
    frames of 448², P = 1029) on the card (the fp32 flash kernels) and on
    the host CPU (plain attention), from the same teacher, trainables and
    inputs, with random nonzero LoRA B factors so every factor has a
    gradient: loss terms and gradients compared."""
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.nn import encoder as enc
    from vist3a_tpu_torch.nn.layers import build_random
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca
    from vist3a_tpu_torch.train import stitching as st

    cfg = narrow_config()
    gen = torch.Generator().manual_seed(11)
    teacher = build_random(lambda: enc.Encoder(cfg.encoder, vit_start=0),
                           gen, "cpu", torch.float32)
    teacher.camera_head.pose_branch.fc2.bias.copy_(torch.tensor(CAMERA_BIAS))
    stitch_conv = build_random(lambda: ca.init_stitch_conv(cfg), gen, "cpu",
                               torch.float32)
    tcfg = st.StitchTrainConfig(lora_spec="r4,a8,d0.0,f0")
    state, _ = st.init_train_state(gen, teacher, stitch_conv, cfg, tcfg)
    with torch.no_grad():
        for f in state.trainable["lora"].values():
            f["b"].normal_(std=0.02, generator=gen)
    latent = torch.randn(1, 16, 2, 64, 64, generator=gen)
    images = torch.rand(1, 3, 5, IMAGE, IMAGE, generator=gen) * 2 - 1
    teacher01 = ((images + 1.0) * 0.5).transpose(1, 2)

    def step(device):
        tch = teacher.to(device)
        trainable = {"lora": {s: {k: torch.nn.Parameter(v.detach().to(device))
                                  for k, v in f.items()}
                              for s, f in state.trainable["lora"].items()},
                     "model": {n: torch.nn.Parameter(p.detach().to(device))
                               for n, p in state.trainable["model"].items()}}
        _, frozen = st.split_params(tch, None, cfg, tcfg.lora)
        with torch.no_grad():
            tout = enc.forward(tch, teacher01.to(device), cfg.encoder)
        total, losses = st.loss_fn(trainable, frozen, tout, latent.to(device),
                                   images.to(device), cfg, tcfg.lora)
        total.backward()
        names = [f"lora.{s}.{k}" for s, f in trainable["lora"].items()
                 for k in ("a", "b")] + list(trainable["model"])
        grads = {n: p.grad.detach().cpu() for n, p in
                 zip(names, st.trainable_list(trainable))}
        return {k: v.item() for k, v in losses.items()}, grads

    t0 = time.perf_counter()
    loss_cpu, grads_cpu = step("cpu")
    cpu_s = time.perf_counter() - t0
    before = _train_counts(fa)
    loss_card, grads_card = step("cuda")
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _train_counts(fa).items()}
    check(grew["unmasked"] > 0 and grew["backward"] > 0,
          f"the narrow step launched {grew}")
    loss_err = max(abs(loss_card[k] - v) / max(abs(v), 1e-30)
                   for k, v in loss_cpu.items())
    leaf_err = {n: ((grads_card[n] - g).abs().max()
                    / g.abs().max().clamp_min(1e-30)).item()
                for n, g in grads_cpu.items()}
    num = sum(((grads_card[n] - g) ** 2).sum() for n, g in grads_cpu.items())
    den = sum((g ** 2).sum() for g in grads_cpu.values())
    global_err = (num / den).sqrt().item()
    worst = sorted(leaf_err, key=leaf_err.get, reverse=True)[:3]
    log(f"train reference: narrow step, card vs host CPU ({cpu_s:.1f} s "
        f"there), launches {grew}: loss terms max rel err {loss_err:.3g}; "
        f"gradients ‖Δ‖/‖g‖ {global_err:.3g}, worst leaves "
        f"{[(n, round(leaf_err[n], 6)) for n in worst]}")
    # fp32 on both sides (TF32 off); the sums run in other orders, and an
    # L1 term's sign at a near-tie of student and teacher may differ
    # (see tests/test_torch_stitch_train.py), which moves a few elements of
    # the GS head's gradients: hence a global and a per-leaf limit
    check(loss_err <= 1e-4 and global_err <= 1e-3
          and max(leaf_err.values()) <= 5e-2,
          f"narrow training step: card and host CPU disagree (loss "
          f"{loss_err}, gradients {global_err}, worst leaf "
          f"{leaf_err[worst[0]]})")
    return {"loss_rel_err": loss_err, "grad_rel_err": global_err,
            "worst_leaf_rel_err": leaf_err[worst[0]]}


def vdm_launches(num_steps: int, n_layers: int = 30) -> dict:
    """Kernel launches of one full-width VDM step with a `num_steps`
    rollout, as the code makes them: the DiT's self-attention (natural
    forward) in the SFT forward and its recompute, every rollout step (no
    grad, no recompute), and the re-evaluation and its recompute; its
    backward (kernel 5) in the SFT branch and the re-evaluation; the
    stitched decoder's 8 ViT blocks and 24 + 24 trunk attentions, forward
    and recompute (bf16 D = 64), and their backward (kernel 4b); the 13
    rendered views' composite, forward and per-view recompute, and its
    backward (kernel 7); the q/k prologue, 3 a block, in the rollout's
    steps alone (the forwards with grad run its plain version)."""
    return {"natural": n_layers * (num_steps + 4), "unmasked": 2 * 56,
            "masked": 0, "backward": 0, "backward_bf16": 56,
            "backward_natural": 2 * n_layers, "composite": 2 * 13,
            "composite_backward": 13, "qk_prologue": 3 * n_layers * num_steps}


def _vdm_counts() -> dict:
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import qk_prologue as qkp
    from vist3a_tpu_torch.kernels import rasterizer as tr

    return {"natural": fa.launches_natural,
            "unmasked": fa.launches_unmasked, "masked": fa.launches_masked,
            "backward": fa.launches_backward,
            "backward_bf16": fa.launches_backward_bf16,
            "backward_natural": fa.launches_backward_natural,
            "composite": tr.launches,
            "composite_backward": tr.launches_backward,
            "qk_prologue": qkp.launches}


def _reset_counts() -> None:
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import qk_prologue as qkp
    from vist3a_tpu_torch.kernels import rasterizer as tr

    fa.reset_launch_counts()
    tr.reset_launch_counts()
    qkp.reset_launch_counts()


def build_vdm():
    """The VDM step's models at full width, random weights drawn on the
    card from seeds: UMT5-XXL and the Wan 2.1 1.3B DiT in bf16
    (`build_generator`), the stitched decoder in bf16 (`build_stitched`),
    the Wan VAE encoder and decoder in fp32, and the two CLIP-H vision
    towers (PickScore's at 224², DFN5B's at 378²) in fp32."""
    import torch

    from vist3a_tpu_torch.nn import clip, wan_vae
    from vist3a_tpu_torch.pipelines import t23d

    cfg = t23d.T23DConfig()
    models = {**build_generator(cfg), "stitched": build_stitched()}
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, fn, mcfg in (
            ("vae_encoder", wan_vae.init_encoder, cfg.vae),
            ("vae_decoder", wan_vae.init_decoder, cfg.vae),
            ("pick", clip.init, clip.CLIP_H_224),
            ("pe", clip.init, clip.DFN5B_H_378)):
        t0 = time.perf_counter()
        models[name] = fn(mcfg, gen, device="cuda")
        torch.cuda.synchronize()
        n = sum(p.numel() for p in models[name].parameters())
        log(f"model: {name}, {n} parameters (fp32), built on the card in "
            f"{time.perf_counter() - t0:.1f} s")
    return cfg, models


def _checksums(models: dict) -> dict:
    return {name: [p.double().sum().item() for p in m.parameters()]
            for name, m in models.items() if name != "umt5"}


def phase_vdm() -> dict:
    """Two full-width VDM steps through `run`, their checks, launches,
    times and peak memory; a narrow step card vs host CPU."""
    import numpy as np
    import torch

    from vist3a_tpu_torch.cli import train_vdm as cli
    from vist3a_tpu_torch.pipelines import t23d
    from vist3a_tpu_torch.train import ema as ema_mod
    from vist3a_tpu_torch.train import reward, vdm

    torch.cuda.empty_cache()
    cfg, m = build_vdm()
    tokenize = fake_tokenizer(cfg.umt5)
    vcfg = vdm.VDMTrainConfig()
    gen = torch.Generator(device="cuda").manual_seed(13)
    clip_video = torch.rand(VDM_CLIP, generator=gen, device="cuda") * 2 - 1
    feats = [torch.nn.functional.normalize(
        torch.randn(1, tower.cfg.projection_dim, generator=gen,
                    device="cuda"), dim=-1) for tower in (m["pick"], m["pe"])]
    loss_fn = reward.make_loss_fn(m["pick"], m["pe"], logit_scale=100.0)

    def embed_text(texts):
        return torch.cat([t23d.embed_prompts(m["umt5"], tokenize, t)[0]
                          for t in texts])
    uncond = t23d.embed_prompts(m["umt5"], tokenize, PROMPT)[1]
    state = vdm.init_train_state(gen, m["dit"], vcfg)
    n_lora = sum(p.numel() for p in vdm.flat_lora(state.lora).values())
    log(f"vdm: {len(state.lora)} LoRA sites ({vcfg.lora_spec}), {n_lora} "
        f"trainable parameters; rollout lengths of steps 0 and 1 drawn "
        f"from seed {VDM_SEED}")
    frozen = {k: m[k] for k in ("dit", "vae_encoder", "vae_decoder",
                                "stitched", "pick", "pe")}
    sums_before = _checksums(frozen)
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    marks = []

    def on_metrics(h):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _vdm_counts(),
                      torch.cuda.max_memory_allocated(), h,
                      {k: v.detach().clone()
                       for k, v in vdm.flat_lora(state.lora).items()}))
        torch.cuda.reset_peak_memory_stats()

    ckpt_dir = Path(tempfile.mkdtemp(prefix="vist3a_vdm_ckpt_"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    state, history = cli.run(
        state, m["dit"], m["vae_encoder"], m["vae_decoder"], m["stitched"],
        text_loader=[{"prompt": [PROMPT]}] * VDM_STEPS,
        video_loader=[{"image_tensor": clip_video,
                       "caption": [VDM_CAPTION]}],
        embed_text=embed_text, reward_loss_fn=loss_fn,
        scfg=stitched_config(), cfg=vcfg, num_steps=VDM_STEPS,
        seed=VDM_SEED, latent_shape=cfg.latent_shape, render_size=IMAGE,
        on_metrics=on_metrics, uncond_embeds=uncond,
        reward_text_fn=lambda prompt: tuple(feats), save_path=ckpt_dir,
        save_freq=VDM_STEPS)
    saved_s = time.perf_counter() - marks[-1][0]
    counts = _vdm_counts()
    steps_ms, peaks, prev, prev_t = [], [], {k: 0 for k in counts}, t0
    for i, (tm, c, peak, h, _) in enumerate(marks):
        grew = {k: c[k] - prev[k] for k in c}
        want = vdm_launches(h["num_steps"], cfg.dit.num_layers)
        steps_ms.append((tm - prev_t) * 1e3)
        peaks.append(peak)
        prev, prev_t = c, tm
        losses = {k: h[k] for k in ("diffusion_loss", "reward_loss",
                                    "total_loss", "grad_norm")}
        check(all(math.isfinite(v) for v in losses.values()),
              f"step {i}: non-finite metrics {losses}")
        check(h["grad_norm"] > 0 and not h["skipped"],
              f"step {i}: grad_norm {h['grad_norm']}, skipped "
              f"{h['skipped']}")
        check(grew == want, f"step {i}: launches {grew}, want {want}")
        log(f"vdm: step {i}: rollout {h['num_steps']} steps, backprop "
            f"indices {h['backprop_idx']}, guidance {h['guidance']:.4f}; "
            f"{steps_ms[-1]:.1f} ms, peak memory allocated {peak} B, "
            f"launches {grew}; " + json.dumps(losses))
    check(history[0]["num_steps"] == vcfg.rollout_steps_high,
          f"step 0 rolled out {history[0]['num_steps']} steps")
    b_max = [f["b"].detach().abs().max().item()
             for f in state.lora.values()]
    check(min(b_max) > 0, f"{sum(b == 0 for b in b_max)} LoRA B factors "
          "never moved")
    # EMA: e_{i+1} = d_i·e_i + (1 − d_i)·p_{i+1}, the factors after step i
    decays = [ema_mod.current_decay(i) for i in range(len(marks))]
    want_ema = dict(ema0)
    for d, mark in zip(decays, marks):
        want_ema = {k: d * e + (1 - d) * mark[4][k]
                    for k, e in want_ema.items()}
    last = marks[-1][4]
    ema_err = max(((state.ema[k] - want_ema[k]).abs().max()
                   / last[k].abs().max().clamp_min(1e-30)).item()
                  for k in state.ema)
    check(ema_err <= 1e-6, f"EMA off its warm-up formula by {ema_err}")
    sums_after = _checksums(frozen)
    changed = [k for k in frozen if sums_after[k] != sums_before[k]]
    check(not changed, f"frozen weights changed: {changed}")
    log(f"vdm: LoRA B factors moved (smallest max |B| {min(b_max):.3g}); "
        f"EMA at its warm-up formula (d = "
        f"{', '.join(f'{d:.4f}' for d in decays)}; rel err "
        f"{ema_err:.3g}); {', '.join(frozen)} unchanged "
        f"({sum(len(v) for v in sums_before.values())} checksums)")
    log(f"vdm: ms per step {steps_ms}; peak memory allocated {peaks} B; "
        f"launches {counts}")
    # the save after the last step (`save_freq`), reloaded into a fresh
    # state: no step
    try:
        t1 = time.perf_counter()
        fresh = vdm.init_train_state(
            torch.Generator(device="cuda").manual_seed(12), m["dit"], vcfg)
        path = cli.restore(ckpt_dir, fresh, np.random.default_rng(0))
        n = same_values("vdm: reloaded", {
            "lora": vdm.flat_lora(state.lora), "ema": state.ema,
            "optimizer": state.optimizer.state_dict()["state"]}, {
            "lora": vdm.flat_lora(fresh.lora), "ema": fresh.ema,
            "optimizer": fresh.optimizer.state_dict()["state"]})
        check(fresh.step == state.step == VDM_STEPS
              and path.endswith(f"checkpoint-{VDM_STEPS}"),
              f"vdm: reloaded {path} at step {fresh.step}")
        files = {p.name: p.stat().st_size for p in Path(path).iterdir()}
        log(f"vdm: saved {path} {files} B after step {VDM_STEPS} "
            f"({saved_s:.1f} s), reloaded into a fresh state in "
            f"{time.perf_counter() - t1:.1f} s: {n} tensors (LoRA, EMA "
            f"shadow, AdamW moments) equal bit for bit")
        del fresh
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    del state, m, loss_fn, uncond, clip_video
    torch.cuda.empty_cache()
    steps = [{k: h[k] for k in ("num_steps", "backprop_idx", "guidance",
                                "diffusion_loss", "reward_loss",
                                "grad_norm")} for h in history]
    return {"ms_per_step": steps_ms, "peak_bytes": peaks,
            "launches": counts, "steps": steps,
            "reference": vdm_reference()}


def narrow_vdm_setup() -> dict:
    """The narrow VDM models, LoRA state, inputs and draws, on the host,
    from one seed: a DiT of 2 layers with 2 heads of 128 at 2048 tokens, a
    Wan VAE of base width 8 on 5 frames of 512², the narrow stitched
    decoder (`narrow_config()`, P = 1029) in bf16, CLIP towers of width 64
    at 224² and 378², a 3-step rollout; the LoRA B factors random and
    nonzero so that every factor has a gradient."""
    import torch

    from vist3a_tpu_torch.nn import clip, wan_dit, wan_vae
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca
    from vist3a_tpu_torch.train import reward, vdm

    gen = torch.Generator().manual_seed(14)
    dcfg = wan_dit.WanDiTConfig(dim=256, ffn_dim=512, num_layers=2,
                                num_heads=2, text_dim=64)
    vae_cfg = wan_vae.WanVAEConfig(base_dim=8)
    scfg = dataclasses.replace(narrow_config(), latent_t=5)
    ccfg = {s: clip.CLIPVisionConfig(hidden_size=64, num_layers=2,
                                     num_heads=2, mlp_dim=128, image_size=s,
                                     projection_dim=32) for s in (224, 378)}
    models = {
        "dit": wan_dit.init(dcfg, gen, "cpu", torch.bfloat16),
        "enc": wan_vae.init_encoder(vae_cfg, gen, "cpu"),
        "dec": wan_vae.init_decoder(vae_cfg, gen, "cpu"),
        "stitched": ca.init(scfg, gen, "cpu", torch.bfloat16),
        "pick": clip.init(ccfg[224], gen, "cpu"),
        "pe": clip.init(ccfg[378], gen, "cpu")}
    models["stitched"].encoder.camera_head.pose_branch.fc2.bias.copy_(
        torch.tensor(CAMERA_BIAS))
    vcfg = vdm.VDMTrainConfig(rollout_steps_low=3, rollout_steps_high=3)
    lora = vdm.init_train_state(gen, models["dit"], vcfg).lora
    with torch.no_grad():
        for f in lora.values():
            f["b"].normal_(std=0.02, generator=gen)
    lat = (1, 16, 2, 64, 64)
    inputs = {
        "video": torch.rand(1, 3, 5, 512, 512, generator=gen) * 2 - 1,
        "text": torch.randn(1, 12, dcfg.text_dim, generator=gen),
        "feat": torch.nn.functional.normalize(
            torch.randn(1, 32, generator=gen), dim=-1)}
    draws = {"num_steps": 3, "backprop_idx": [0, 1, 2], "guidance": 5.0,
             "posterior_eps": torch.randn(lat, generator=gen),
             "flow_eps": torch.randn(lat, generator=gen),
             "flow_sigma": torch.tensor([0.4]),
             "latents0": torch.randn(lat, generator=gen),
             "perm": torch.arange(5), "frame": 2}
    return {"dcfg": dcfg, "scfg": scfg, "vcfg": vcfg, "models": models,
            "lora": lora, "inputs": inputs, "draws": draws, "lat": lat,
            "rcfg": reward.RewardConfig(pick_cfg=ccfg[224],
                                        pe_cfg=ccfg[378])}


def _pinned(x, value):
    """x's value replaced by `value`, x's gradient path kept."""
    return x + (value.to(x) - x).detach()


def narrow_reward_grads(setup: dict, device, stitched, vae_dtype, *,
                        noise: float = 0.0, pin: dict | None = None
                        ) -> tuple:
    """The reward branch of the narrow step alone, from one latent (the
    un-normalised `latents0`, times 1 + noise·N(0, 1) with a fixed seed):
    the differentiable VAE decode in `vae_dtype` activations, then
    `calculate_reward` through `stitched`, rendering the first
    `VDM_REF_REWARD_VIEWS` views.  `pin`, what another run
    returned: the decoded clip and the Gaussians and cameras that the
    stitched decoder hands to the render take that run's values, their
    gradients still flowing through this run's graph, so the render's
    thresholds (the 1e-4 stop, α ≥ 1/255, the pair budget's cut) see the
    same inputs on both sides; with pin["cotangents"], the gradients that
    reach those Gaussians and cameras from the render are that run's too;
    with pin["views"], each view's pair stream (`gid`, `bounds`) is that
    run's, in place of the one this run builds.
    → (loss, gradients: `stitched` with respect to the latent through the
    stitched decoder alone, `video` with respect to the decoded clip,
    `latent` the whole, through the decode too; the values, cotangents and
    pair streams to pin another run to, with each view's attribute table
    (`views`, one entry per `view_pairs` call, the recomputes included,
    holding what this run built))."""
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr
    from vist3a_tpu_torch.nn import wan_vae
    from vist3a_tpu_torch.train import reward

    ms, draws = setup["models"], setup["draws"]
    dec, st = ms["dec"].to(device), stitched.to(device)
    loss_fn = reward.make_loss_fn(ms["pick"].to(device), ms["pe"].to(device),
                                  logit_scale=100.0, cfg=setup["rcfg"])
    lat_un = wan_vae.unnormalize_latents(draws["latents0"])
    if noise:
        gen = torch.Generator().manual_seed(99)
        lat_un = lat_un * (1 + noise * torch.randn(lat_un.shape,
                                                   generator=gen))
    lat_un = lat_un.to(device).requires_grad_()
    decoded = wan_vae.decode(dec, lat_un.to(vae_dtype), remat=True).float()
    video = decoded.detach().requires_grad_()
    values = {"video": video.detach().cpu(), "cotangents": {}, "views": []}
    cot = (pin or {}).get("cotangents")
    pinned_views = (pin or {}).get("views")
    view_pairs = tr.view_pairs

    def recorded_view_pairs(*args):
        """`tr.view_pairs`, recording its table and pairs; with pinned
        views, handing on the other run's pairs instead."""
        table, pairs = view_pairs(*args)
        i = len(values["views"])
        values["views"].append({"table": table.detach().cpu(),
                                "gid": pairs.gid.cpu(),
                                "bounds": pairs.bounds.cpu(),
                                "total": pairs.total})
        if pinned_views is not None:
            other = pinned_views[i]
            pairs = tr.Pairs(other["gid"].to(pairs.gid.device),
                             other["bounds"].to(pairs.gid.device),
                             other["total"])
        return table, pairs

    def tap(name, x):
        """Records the gradient reaching x; hands on the pinned one."""
        def hook(grad):
            values["cotangents"][name] = grad.detach().cpu()
            return None if cot is None else cot[name].to(grad)
        x.register_hook(hook)
        return x

    def stitched_hook(module, args, out):
        fields = dict(zip(out.gaussians._fields, out.gaussians))
        fields.update(c2w=out.extrinsic_c2w, intr=out.intrinsic_norm)
        if pin is not None:
            fields = {k: _pinned(x, pin["values"][k])
                      for k, x in fields.items()}
        values["values"] = {k: x.detach().cpu() for k, x in fields.items()}
        # a fresh node each, so a hook sees only the render's gradient (the
        # decoder's own covariances are made from its scales and rotations)
        fields = {k: tap(k, x.view_as(x)) if x.requires_grad else x
                  for k, x in fields.items()}
        return out._replace(
            gaussians=type(out.gaussians)(
                *(fields[k] for k in out.gaussians._fields)),
            extrinsic_c2w=fields["c2w"], intrinsic_norm=fields["intr"])

    handle = st.register_forward_hook(stitched_hook)
    feat = setup["inputs"]["feat"].to(device)
    tr.view_pairs = recorded_view_pairs
    try:
        loss, _ = reward.calculate_reward(
            lat_un, video if pin is None else _pinned(video, pin["video"]),
            st, setup["scfg"], loss_fn, perm=draws["perm"].to(device),
            frame=draws["frame"], num_render_views=VDM_REF_REWARD_VIEWS,
            render_size=IMAGE, pair_budget=VDM_REF_PAIRS,
            text_feats=(feat, feat))
        g_st, g_video = torch.autograd.grad(loss, (lat_un, video))
    finally:
        handle.remove()
        tr.view_pairs = view_pairs
    g_dec, = torch.autograd.grad(decoded, lat_un, g_video)
    return float(loss.detach()), {"stitched": g_st.cpu(),
                                  "video": g_video.cpu(),
                                  "latent": (g_st + g_dec).cpu()}, values


def rel_dist(a, b) -> float:
    """‖a − b‖ / ‖b‖ over the tensors of two dicts with b's keys."""
    num = sum(((a[k] - g) ** 2).sum() for k, g in b.items())
    return (num / sum((g ** 2).sum() for g in b.values())).sqrt().item()


def render_set_flips(card: list, host: list) -> list:
    """Card against host, view by view (the forward `view_pairs` calls of
    `narrow_reward_grads`, each side's own build from the same Gaussians
    and cameras), the members of each set that the render's thresholds
    select: the Gaussians the opacity cull keeps (op ≥ 1/255 and a valid
    projection), the (tile, Gaussian) pairs the budget keeps of `total`,
    and per pixel, over the card's pair stream with each side's attribute
    table (`composite_ref` on the host), the pairs evaluated up to the 1e-4
    stop and the pairs composited (a_raw ≥ 1/255); and each column's
    largest difference between the two tables (projection and SH) over its
    largest magnitude."""
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr

    ntx = IMAGE // tr.TILE
    rows = []
    for c, h in zip(card[:VDM_REF_REWARD_VIEWS], host[:VDM_REF_REWARD_VIEWS]):
        g = c["table"].shape[0]

        def pair_keys(v):
            tile = torch.searchsorted(
                v["bounds"].long(), torch.arange(v["gid"].numel()),
                right=True) - 1
            return tile * g + v["gid"].long()

        kc, kh = pair_keys(c), pair_keys(h)
        kept_c = c["table"][:, 5] >= tr.ALPHA_MIN
        kept_h = h["table"][:, 5] >= tr.ALPHA_MIN
        work = [tr.composite_ref(c["gid"], c["bounds"], t, ntx, IMAGE, IMAGE,
                                 return_work=True)
                for t in (c["table"], h["table"])]
        scale = c["table"].abs().amax(0).clamp_min(1e-30)
        rows.append({
            "gaussians": g, "cull_kept": int(kept_c.sum()),
            "cull_flips": int((kept_c != kept_h).sum()),
            "pairs_total": [c["total"], h["total"]],
            "pairs_kept": int(kc.numel()),
            "pair_flips": int(kc.numel() + kh.numel()
                              - 2 * torch.isin(kc, kh).sum()),
            "stop_pixel_flips": int((work[0][1] != work[1][1]).sum()),
            "composited_pixel_flips": int((work[0][2] != work[1][2]).sum()),
            "table_rel_err_by_column": (
                (c["table"] - h["table"]).abs().amax(0) / scale).tolist()})
    return rows


def narrow_reward_reference(setup: dict) -> dict:
    """The reward branch of the narrow step alone (`narrow_reward_grads`),
    card against host CPU, in fp32 (the stitched trunk and the VAE
    activations; kernels 1 and 4 in fp32, 6 and 7) and in the deployed bf16
    (kernel 4b), the host's render inputs, each view's pair stream and the
    render's cotangents pinned to the card's: the gradients with respect
    to the latent, through the stitched decoder and through the decode, and
    to the decoded clip, and apart the render's cotangents from the same
    inputs and pairs; and the members of each set the render's thresholds
    select, counted card vs host (`render_set_flips`)."""
    import torch

    models = setup["models"]
    # the stitched decoder in fp32 with the bf16 model's values
    stitched32 = copy.deepcopy(models["stitched"]).float()
    res = {}
    for name, stitched, vae_dtype in (
            ("fp32", stitched32, torch.float32),
            ("bf16", models["stitched"], torch.bfloat16)):
        _reset_counts()
        r_card, g_card, values = narrow_reward_grads(setup, "cuda", stitched,
                                                     vae_dtype)
        torch.cuda.synchronize()
        grew = _vdm_counts()
        kernel = "backward" if name == "fp32" else "backward_bf16"
        other = "backward_bf16" if name == "fp32" else "backward"
        check(grew[kernel] > 0 and grew[other] == 0
              and grew["composite_backward"] == VDM_REF_REWARD_VIEWS,
              f"the narrow {name} reward branch launched {grew}")
        t0 = time.perf_counter()
        r_cpu, g_cpu, host = narrow_reward_grads(setup, "cpu", stitched,
                                                 vae_dtype, pin=values)
        cpu_s = time.perf_counter() - t0
        res[f"reward_{name}_loss_rel_err"] = abs(r_card - r_cpu) / abs(r_cpu)
        res[f"reward_{name}_grad_rel_err"] = {
            k: rel_dist({k: g_card[k]}, {k: g}) for k, g in g_cpu.items()}
        res[f"reward_{name}_grad_rel_err"]["render"] = rel_dist(
            values["cotangents"], host["cotangents"])
        res[f"reward_{name}_decoded_rel_err"] = rel_dist(
            {"clip": values["video"]}, {"clip": host["video"]})
        log(f"vdm reference: narrow reward branch in {name}, card vs host "
            f"CPU pinned to the card's render inputs, pairs and "
            f"cotangents ({cpu_s:.1f} s there), launches {grew}: loss {r_card} vs "
            f"{r_cpu}; gradients ‖Δ‖/‖g‖ "
            f"{res[f'reward_{name}_grad_rel_err']}; the decoded clip "
            f"(logged) {res[f'reward_{name}_decoded_rel_err']:.4g}")
        res[f"reward_{name}_render_sets"] = render_set_flips(
            values["views"], host["views"])
        log(f"vdm reference: narrow reward branch in {name}, the render's "
            f"sets card vs host by view: "
            f"{json.dumps(res[f'reward_{name}_render_sets'])}")
    return res


def vdm_reference() -> dict:
    """One narrow VDM step (`narrow_vdm_setup`) on the card (the kernels)
    and on the host CPU (plain attention and composite), from the same
    weights, LoRA state and draws, in the deployed dtypes on both sides
    (DiT and stitched trunk bf16, VAE activations bf16): the whole step's
    losses, and the gradients of the step without its reward (the SFT
    branch: the VAE encode, the LoRA'd DiT and kernel 5).  Then the reward
    branch alone from one latent (`narrow_reward_grads`), in fp32 (the
    stitched trunk and the VAE activations; kernels 1 and 4 in fp32, 6 and
    7) and in the deployed bf16 (kernel 4b), the host's render inputs and
    the render's cotangents pinned to the card's values: its gradients
    with respect to the latent, through the stitched decoder and through
    the decode, and to the decoded clip, and apart the render's cotangents
    from the same inputs.  The whole step's gradient is logged, not held:
    unpinned, the reward's gradient moves by O(1) under input changes of
    1e-6 on the host alone (`tools/torch_reward_sensitivity.py`)."""
    import torch

    from vist3a_tpu_torch.train import ema, reward, vdm

    setup = narrow_vdm_setup()
    models, lora, draws = setup["models"], setup["lora"], setup["draws"]
    dcfg, vcfg = setup["dcfg"], setup["vcfg"]

    def step(device, rl: bool):
        ms = {k: v.to(device) for k, v in models.items()}
        lo = {s: {k: torch.nn.Parameter(v.detach().to(device, copy=True))
                  for k, v in f.items()} for s, f in lora.items()}
        state = vdm.VDMTrainState(0, lo, vdm.build_optimizer(lo, vcfg),
                                  ema.init_ema(vdm.flat_lora(lo)))
        x = {k: v.to(device) for k, v in setup["inputs"].items()}
        loss_fn = reward.make_loss_fn(ms["pick"], ms["pe"], logit_scale=100.0,
                                      cfg=setup["rcfg"])
        met = vdm.vdm_train_step(
            state, ms["dit"], ms["enc"], ms["dec"], ms["stitched"],
            video=x["video"], sft_text=x["text"], rl_cond=x["text"],
            rl_uncond=torch.zeros_like(x["text"]),
            reward_loss_fn=loss_fn if rl else None,
            seed=0, scfg=setup["scfg"], cfg=vcfg, latent_shape=setup["lat"],
            render_size=IMAGE, pair_budget=VDM_REF_PAIRS,
            reward_text=(x["feat"], x["feat"]),
            draws={k: v.to(device) if isinstance(v, torch.Tensor) else v
                   for k, v in draws.items()})
        grads = {f"{s}.{k}": state.optimizer.state[f[k]]["exp_avg"].cpu()
                 for s, f in lo.items() for k in "ab"}
        return {k: float(met[k]) for k in ("diffusion_loss", "reward_loss",
                                           "grad_norm")}, grads

    res = {}
    for rl in (False, True):
        t0 = time.perf_counter()
        loss_cpu, g_cpu = step("cpu", rl)
        cpu_s = time.perf_counter() - t0
        _reset_counts()
        loss_card, g_card = step("cuda", rl)
        torch.cuda.synchronize()
        grew = _vdm_counts()
        check(grew["backward_natural"] == (2 if rl else 1) * dcfg.num_layers
              and (grew["backward_bf16"] > 0) == rl
              and grew["composite_backward"] == (5 if rl else 0),
              f"the narrow step launched {grew}")
        tag = "step" if rl else "sft"
        res[f"{tag}_loss_rel_err"] = {
            k: abs(loss_card[k] - v) / max(abs(v), 1e-30)
            for k, v in loss_cpu.items() if k != "grad_norm"}
        res[f"{tag}_grad_rel_err"] = rel_dist(g_card, g_cpu)
        log(f"vdm reference: narrow {tag}, card vs host CPU ({cpu_s:.1f} s "
            f"there), launches {grew}: losses {loss_card} vs {loss_cpu}; "
            f"loss rel err {res[f'{tag}_loss_rel_err']}, gradients ‖Δ‖/‖g‖ "
            f"{res[f'{tag}_grad_rel_err']:.4g}")

    res.update(narrow_reward_reference(setup))
    # bf16 DiT and stitched trunk, bf16 VAE activations, rounded at other
    # places on the two sides (kernels vs plain math, cuBLAS/cuDNN vs CPU),
    # through a 3-step rollout, the decode and the render
    losses = {**res["sft_loss_rel_err"], **res["step_loss_rel_err"],
              "reward_fp32": res["reward_fp32_loss_rel_err"],
              "reward_bf16": res["reward_bf16_loss_rel_err"]}
    check(max(losses.values()) <= VDM_REF_LOSS_RTOL
          and res["sft_grad_rel_err"] <= VDM_REF_GRAD_RTOL
          and all(err <= VDM_REF_REWARD_GRAD_RTOL[name][k]
                  for name in ("fp32", "bf16")
                  for k, err in res[f"reward_{name}_grad_rel_err"].items()),
          f"narrow VDM step: card and host CPU disagree: {res}")
    return res


# --------------------------------------------------------------------------- #
# phase `distributed`: the multi-GPU layer on a one-rank NCCL launch          #
# --------------------------------------------------------------------------- #
def free_port() -> int:
    """A TCP port on localhost no one listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


LAUNCHER_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


@contextlib.contextmanager
def launcher_env():
    """The environment `torchrun --nproc_per_node 1` gives its one rank
    (a free port for the rendezvous), restored on exit."""
    old = {k: os.environ.get(k) for k in LAUNCHER_KEYS}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def max_diff(a: dict, b: dict) -> float:
    """The largest |a − b| over the tensors and floats of two flat dicts
    with the same keys (inf where a value is not finite on one side)."""
    import torch

    check(a.keys() == b.keys(), f"keys {sorted(a.keys() ^ b.keys())[:5]}")
    worst = 0.0
    for k in a:
        x, y = (torch.as_tensor(v).double().cpu() for v in (a[k], b[k]))
        d = (x - y).abs().max().item() if x.numel() else 0.0
        worst = max(worst, d if math.isfinite(d) else math.inf)
    return worst


def dist_distillation(mesh) -> dict:
    """`cli.train_stitching.run` for one step at DIST_VIEWS views, once
    plain and once on the mesh (DDP: the noise drawn for the global batch,
    the confidence quantile over it, the gradients averaged as one bucket
    before the clip, the loss terms averaged), from the same seed, with
    cuDNN's deterministic algorithms; then the plain step once more with
    its default ones, whose distance from the first is the run-to-run
    spread of the plain step (the stitch conv's weight gradient)."""
    import torch

    from vist3a_tpu_torch.cli import train_stitching as cli
    from vist3a_tpu_torch.pipelines import t23d
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca
    from vist3a_tpu_torch.train import stitching as st

    cfg = ca.StitchedConfig()
    teacher, stitch_conv, vae = build_trainer(cfg)
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
    clip = torch.rand((1, 3, DIST_VIEWS, 512, 512), generator=gen,
                      device="cuda") * 2 - 1
    batch = {"vae_image_tensor": clip, "feedforward_image_tensor":
             t23d.resize_trilinear_half_pixel(clip, (IMAGE, IMAGE))}
    seed = next(s for s in range(1 << 16)
                if st.sample_view_count(s, 0) == DIST_VIEWS)
    tcfg = st.StitchTrainConfig(lora_spec=TRAIN_LORA, warmup_steps=0,
                                total_steps=10)
    params = {"encoder": teacher, "stitch_conv": stitch_conv, "vae": vae}
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        for name, m, det in (("plain", None, True), ("ddp", mesh, True),
                             ("plain_default", None, False)):
            torch.backends.cudnn.deterministic = det
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, hist = cli.run(params, cfg, [batch], train_cfg=tcfg,
                                  num_epochs=1, seed=seed, log_every=1,
                                  mesh=m)
            torch.cuda.synchronize()
            out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "launches": _vdm_counts(), "metrics": hist[0],
                         "trainable": {n: p.detach().clone() for n, p in zip(
                             _trainable_names(state.trainable),
                             st.trainable_list(state.trainable))}}
            del state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    metrics = {k: v for k, v in out["plain"]["metrics"].items()
               if isinstance(v, float)}

    def diff(name, part):
        got = out[name][part]
        return max_diff({k: got[k] for k in metrics} if part == "metrics"
                        else got, metrics if part == "metrics"
                        else out["plain"][part])
    res = {"views": DIST_VIEWS, "seed": seed,
           "ms": {k: out[k]["ms"] for k in out},
           "launches": out["ddp"]["launches"],
           "max_abs_diff_metrics": diff("ddp", "metrics"),
           "max_abs_diff_trainables": diff("ddp", "trainable"),
           "plain_default_vs_plain": max(diff("plain_default", "metrics"),
                                         diff("plain_default", "trainable"))}
    want = {**{k: 0 for k in res["launches"]}, "unmasked": 72 + 2 * 56,
            "backward": 56}
    check(res["launches"] == want,
          f"distributed: DDP step launches {res['launches']}, want {want}")
    check(all(math.isfinite(v) for v in metrics.values())
          and metrics["grad_norm"] > 0, f"distributed: plain step {metrics}")
    log(f"distributed: the plain distillation step with cuDNN's default "
        f"algorithms is {res['plain_default_vs_plain']} from the same step "
        f"with its deterministic ones")
    del teacher, stitch_conv, vae, params, out
    torch.cuda.empty_cache()
    return res


def _trainable_names(trainable: dict) -> list:
    return ([f"lora.{s}.{k}" for s in trainable["lora"] for k in ("a", "b")]
            + [f"model.{n}" for n in trainable["model"]])


def dist_vdm(mesh) -> dict:
    """One full-width VDM SFT step (`vdm_train_step`, the 1.3B DiT in
    bf16) plain (after a warm-up step), then under each `place_dit`
    placement on a copy of the same DiT, each from the same seed."""
    import torch

    from vist3a_tpu_torch.core import mesh as mesh_mod
    from vist3a_tpu_torch.nn import wan_dit, wan_vae
    from vist3a_tpu_torch.pipelines import t23d
    from vist3a_tpu_torch.train import vdm

    cfg = t23d.T23DConfig()
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED + 1)
    dit = wan_dit.init(cfg.dit, gen, "cuda", torch.bfloat16)
    vae = wan_vae.init_encoder(cfg.vae, gen, device="cuda")
    video = torch.rand(VDM_CLIP, generator=gen, device="cuda") * 2 - 1
    text = torch.randn((1, 226, cfg.dit.text_dim), generator=gen,
                       device="cuda").to(torch.bfloat16)
    vcfg = vdm.VDMTrainConfig(enable_rl=False)

    def step(model, m, how):
        state = vdm.init_train_state(
            torch.Generator(device="cuda").manual_seed(DIST_SEED + 2),
            model, vcfg)
        # nonzero B factors, so that every factor has a gradient
        with torch.no_grad():
            for f in state.lora.values():
                f["b"].normal_(std=0.02, generator=torch.Generator(
                    device="cuda").manual_seed(DIST_SEED + 3))
        mesh_mod.place_dit(model, cfg.dit, m, how)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = vdm.vdm_train_step(
            state, model, vae, None, None, video=video, sft_text=text,
            rl_cond=text, rl_uncond=text, reward_loss_fn=None,
            seed=VDM_SEED, scfg=None, cfg=vcfg,
            latent_shape=cfg.latent_shape, mesh=m)
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t0) * 1e3,
                "launches": _vdm_counts(),
                "metrics": {k: float(h[k]) for k in (
                    "diffusion_loss", "total_loss", "grad_norm")},
                "lora": {k: v.detach().clone()
                         for k, v in vdm.flat_lora(state.lora).items()}}

    step(dit, None, "replicated")          # warm-up: the first call's setup
    plain = step(dit, None, "replicated")
    res = {"plain_ms": plain["ms"], "placements": {}}
    want = {**{k: 0 for k in plain["launches"]},
            "natural": 2 * cfg.dit.num_layers,
            "backward_natural": cfg.dit.num_layers}
    for how in ("fsdp", "tp", "tp_fsdp", "replicated"):
        placed = step(copy.deepcopy(dit), mesh, how)
        res["placements"][how] = {
            "ms": placed["ms"], "launches": placed["launches"],
            "max_abs_diff_metrics": max_diff(placed["metrics"],
                                             plain["metrics"]),
            "max_abs_diff_lora": max_diff(placed["lora"], plain["lora"])}
        check(placed["launches"] == want,
              f"distributed: {how} SFT step launches {placed['launches']}, "
              f"want {want}")
        del placed
        torch.cuda.empty_cache()
    check(all(math.isfinite(v) for v in plain["metrics"].values())
          and plain["metrics"]["grad_norm"] > 0,
          f"distributed: plain SFT step {plain['metrics']}")
    res["launches"] = res["placements"]["fsdp"]["launches"]
    del dit, vae
    torch.cuda.empty_cache()
    return res


def dist_denoise(mesh) -> dict:
    """A DIST_DENOISE_STEPS-step denoise (`t23d.denoise`, CFG batched) of
    the 1.3B DiT in bf16, plain and placed tensor-parallel.  Under TP the
    q/k prologue runs as torch ops, so the plain step it is held against
    runs the kernel's plain version (the same ops) in its place."""
    import torch

    from vist3a_tpu_torch.core import mesh as mesh_mod
    from vist3a_tpu_torch.kernels import qk_prologue as qkp
    from vist3a_tpu_torch.nn import wan_dit
    from vist3a_tpu_torch.pipelines import t23d

    cfg = dataclasses.replace(t23d.T23DConfig(),
                              num_inference_steps=DIST_DENOISE_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED + 4)
    dit = wan_dit.init(cfg.dit, gen, "cuda", torch.bfloat16)
    cond, uncond = (torch.randn((1, 226, cfg.dit.text_dim), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    wan_dit.qk_prologue = qkp.qk_prologue_ref
    try:
        plain = t23d.denoise(dit, cond, uncond, cfg)
    finally:
        wan_dit.qk_prologue = qkp.qk_prologue
    mesh_mod.place_dit(dit, cfg.dit, mesh, "tp")
    _reset_counts()
    got = t23d.denoise(dit, cond, uncond, cfg)
    launches = _vdm_counts()
    want = {**{k: 0 for k in launches},
            "natural": DIST_DENOISE_STEPS * cfg.dit.num_layers}
    check(launches == want,
          f"distributed: TP denoise launches {launches}, want {want}")
    check(bool(torch.isfinite(plain).all()), "distributed: plain denoise")
    res = {"steps": DIST_DENOISE_STEPS, "launches": launches,
           "max_abs_diff": (got - plain).abs().max().item()}
    del dit, plain, got
    torch.cuda.empty_cache()
    return res


def phase_distributed() -> dict:
    """The multi-GPU layer on the card, at world 1: the launcher's
    environment, `setup_dist` (NCCL, the rank pinned to its device), a
    1×1 mesh, a one-tensor all-reduce, then DDP distillation, the four VDM
    placements and the TP denoise, each against its plain step from the
    same state: at world 1 every collective is a copy, so each maximum
    |Δ| is expected to be 0.  `cleanup` at the end."""
    import torch
    import torch.distributed as dist

    from vist3a_tpu_torch.core import distributed
    from vist3a_tpu_torch.core import mesh as mesh_mod

    torch.cuda.empty_cache()
    with launcher_env():
        check(distributed.setup_dist("cuda"),
              "distributed: setup_dist started no process group")
        try:
            backend = dist.get_backend()
            mesh = mesh_mod.create_mesh()
            check(backend == "nccl" and mesh.shape == {"data": 1, "model": 1}
                  and mesh.device_mesh is not None,
                  f"distributed: backend {backend}, mesh {mesh.shape}")
            x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
            y = x.clone()
            dist.all_reduce(y)
            check(torch.equal(x, y), "distributed: the one-rank NCCL "
                  "all-reduce changed its tensor")
            log(f"distributed: backend {backend}, world "
                f"{dist.get_world_size()}, mesh {mesh.shape}, device "
                f"{torch.cuda.current_device()}; a {x.numel()}-element "
                f"all-reduce returned its tensor")
            res = {"backend": backend,
                   "distillation": dist_distillation(mesh),
                   "vdm": dist_vdm(mesh), "denoise": dist_denoise(mesh)}
        finally:
            distributed.cleanup()
    check(not dist.is_initialized(), "distributed: cleanup left the group")
    diffs = {"distillation": max(res["distillation"][k] for k in (
        "max_abs_diff_metrics", "max_abs_diff_trainables")),
        **{f"vdm_{how}": max(p["max_abs_diff_metrics"],
                             p["max_abs_diff_lora"])
           for how, p in res["vdm"]["placements"].items()},
        "denoise_tp": res["denoise"]["max_abs_diff"]}
    res["max_abs_diff"] = diffs
    log("distributed: max |wrapped − plain| " + json.dumps(diffs)
        + "; ms " + json.dumps({
            "distillation": {k: round(v, 1) for k, v in
                             res["distillation"]["ms"].items()},
            "vdm_plain": round(res["vdm"]["plain_ms"], 1),
            **{f"vdm_{h}": round(p["ms"], 1)
               for h, p in res["vdm"]["placements"].items()}})
        + "; launches " + json.dumps({
            "distillation": res["distillation"]["launches"],
            "vdm": res["vdm"]["launches"],
            "denoise": res["denoise"]["launches"]}))
    check(all(v <= DIST_MAX_ABS_DIFF for v in diffs.values()),
          f"distributed: a wrapped step differs from its plain one: {diffs}")
    return res


# --------------------------------------------------------------------------- #
# phase `workflows`: the three command lines on files on disk                  #
# --------------------------------------------------------------------------- #
def scene_frame(i: int, hw: tuple, seed: int):
    """A structured RGB frame (uint8): four coloured Gaussian blobs that
    move with the frame index over a lit gradient."""
    import numpy as np

    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.3 + 0.4 * xx / w, 0.25 + 0.3 * yy / h,
                    0.5 - 0.2 * xx / w], axis=-1)
    for _ in range(4):
        colour = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        vx, vy = rng.uniform(-0.01, 0.01, 2) * np.float32(max(h, w))
        sigma = rng.uniform(0.05, 0.15) * min(h, w)
        blob = np.exp(-((xx - cx - vx * i) ** 2 + (yy - cy - vy * i) ** 2)
                      / (2 * sigma * sigma))
        img = img * (1 - blob[..., None]) + colour * blob[..., None]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_scenes(folder: Path, *, hw=WORKFLOW_HW,
                 scannet_hw=WORKFLOW_SCANNET_HW, frames=WORKFLOW_FRAMES,
                 caption_frames=WORKFLOW_CAPTION_FRAMES) -> dict:
    """The datasets the command lines read, written with OpenCV (the card
    machine has no Pillow): a DL3DV tree of `WORKFLOW_DL3DV_SCENES` scenes
    `dl3dv/1K/scene_{a,...}/images_4/frame_XXXXX.png`, its caption JSON
    (scene_a captioned over frames
    [0, caption_frames)), a one-scene ScanNet tree `scannet/scene0000_00/
    frames/color/<i>.png` and a prompt list.  Returns their paths."""
    import cv2

    paths = {"dl3dv": folder / "dl3dv", "scannet": folder / "scannet",
             "captions": folder / "captions.json",
             "prompts": folder / "prompts.txt"}
    dirs = [(paths["dl3dv"] / "1K" / f"scene_{c}" / "images_4", hw,
             "frame_{:05d}.png", k) for k, c in enumerate(
                 "ab"[:WORKFLOW_DL3DV_SCENES])]
    dirs.append((paths["scannet"] / "scene0000_00" / "frames" / "color",
                 scannet_hw, "{}.png", 2))
    for d, size, name, seed in dirs:
        d.mkdir(parents=True)
        for i in range(frames):
            ok = cv2.imwrite(str(d / name.format(i)),
                             scene_frame(i, size, seed)[:, :, ::-1])
            check(ok, f"workflows: cv2 could not write {d / name.format(i)}")
    paths["captions"].write_text(json.dumps([{
        "scene_name": "scene_a",
        "caption": {f"cap_0_{caption_frames - 1}": VDM_CAPTION}}]))
    paths["prompts"].write_text("\n".join(WORKFLOW_PROMPTS) + "\n")
    return paths


def workflow_seed(views=WORKFLOW_STITCH_VIEWS) -> int:
    """The smallest seed whose view-count draws for the distillation
    main's steps are `views`."""
    from vist3a_tpu_torch.train import stitching as st

    return next(s for s in range(1 << 16)
                if [st.sample_view_count(s, i) for i in range(len(views))]
                == list(views))


@contextlib.contextmanager
def captured(module, name: str, store: dict, *, first: bool = False):
    """Wrap `module.<name>`: the arguments and the result of its last call
    (with `first`, its first) go to store[name] as (args, kwargs, result);
    restored on exit."""
    fn = getattr(module, name)

    def wrap(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not (first and name in store):
            store[name] = (args, kwargs, out)
        return out
    setattr(module, name, wrap)
    try:
        yield store
    finally:
        setattr(module, name, fn)


def measured_main(label: str, fn, args, *, device: str, timed: tuple = (),
                  phase: str = "workflows", launcher: bool = False) -> tuple:
    """fn(args, device=device) with the launch counts reset before it, the
    peak device memory from its start, the seconds spent reading files
    (`io/load_weights.py`) and in each of `timed` ((module, names) pairs).
    With `launcher`, under a one-rank torchrun's environment
    (`launcher_env`): the main must start its process group through
    `setup_dist` (NCCL) and destroy it before it returns.
    Returns (fn's result, {"seconds", "read_s", "calls": {name: [s]},
    "peak_bytes", "start_bytes" (allocated when it began), "end_bytes"
    (allocated after it, its result alive), "launches"})."""
    import torch
    import torch.distributed as dist

    from vist3a_tpu_torch.core import distributed
    from vist3a_tpu_torch.io import load_weights

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # what an earlier main left in reference cycles goes first, so the
    # peak is this main's
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated() if cuda else None
    _reset_counts()
    reads, calls, setups = [], [], {}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_calls(load_weights, (
            "load_torch_state_dict", "load_sharded_safetensors"), reads,
            sync))
        for module, names in timed:
            stack.enter_context(timed_calls(module, names, calls, sync))
        if launcher:
            stack.enter_context(launcher_env())
            stack.enter_context(captured(distributed, "setup_dist", setups))
        # held in a list emptied on return: a failed `wandb.init` keeps its
        # exception, and with it this frame, after the call returns
        # (PERF.md §7), so no local of this frame may hold the result
        out = [fn(args, device=device)]
    sync()
    if launcher:
        check(setups.get("setup_dist", (0, 0, False))[2] is True
              and not dist.is_initialized(),
              f"{phase}: {label} did not start (or did not destroy) its "
              "process group")
    gc.collect()
    info = {"seconds": time.perf_counter() - t0,
            "read_s": sum(x for _, _, x in reads),
            "calls": {n: [x for m, _, x in calls if m == n]
                      for _, names in timed for n in names},
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda
            else None, "start_bytes": start_bytes,
            "end_bytes": torch.cuda.memory_allocated() if cuda else None,
            "launches": _vdm_counts()}
    log(f"{phase}: {label}: {info['seconds']:.1f} s, read "
        f"{info['read_s']:.1f} s, peak memory allocated "
        f"{info['peak_bytes']} B (at its start {start_bytes} B, after it "
        f"with its result {info['end_bytes']} B), launches "
        f"{info['launches']}, "
        + ("its process group started by setup_dist and destroyed, "
           if launcher else "") + "calls "
        + json.dumps({n: [round(x, 2) for x in v]
                      for n, v in info["calls"].items()}))
    return out.pop(), info


def left_behind(label: str, start_bytes, cuda: bool) -> int | None:
    """The device memory still allocated after a main's results are
    dropped, checked to be what was allocated before it (within
    `LEFT_BEHIND_BYTES`): a main frees what it loaded."""
    import torch

    if not cuda:
        return None
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    log(f"workflows: {label}: {left} B allocated once its results are "
        f"dropped ({start_bytes} B before it)")
    check(left - start_bytes <= LEFT_BEHIND_BYTES,
          f"workflows: {label} left {left - start_bytes} B allocated")
    return left


def drive_search(root: Path, data: dict, out: Path, scfg, flags: tuple, *,
                 device: str, want_launches: dict | None) -> dict:
    """`cli/find_layer.py::main` twice (the second reads the cache), its
    checks; returns the times, the MSEs and the artifact folder."""
    import numpy as np
    import torch

    from vist3a_tpu_torch.cli import arguments, find_layer, model_loading
    from vist3a_tpu_torch.io import checkpoints as ckpt
    from vist3a_tpu_torch.nn import vit as vit_mod
    from vist3a_tpu_torch.nn.aggregator import IMAGENET_MEAN, IMAGENET_STD
    from vist3a_tpu_torch.search import ridge

    args = arguments.find_layer_stitching_argument().parse_args([
        "--dataset", f"dl3dv:{data['dl3dv']}", "--feature_save_path",
        str(out), "--iterations_for_feature_extraction",
        str(WORKFLOW_SEARCH_SAMPLES), "--stitching_layer_config",
        scfg.conv_spec, *flags])
    args.weights_root = str(root)
    taps = {}

    def first_taps(vit, images01, cfg, **kw):
        # the trunk and images of the first extraction, kept for the check
        feats = extract(vit, images01, cfg, **kw)
        taps.setdefault("in", (vit, images01[0], cfg, feats[-1][0]))
        return feats
    extract = ridge.extract_block_features
    ridge.extract_block_features = first_taps
    try:
        (best, mses), info = measured_main(
            "find_layer.main", find_layer.main, args, device=device,
            timed=((ridge, ("extract_block_features",
                            "fit_conv3d_streaming")),
                   (model_loading, ("load_anysplat_encoder",
                                    "load_wan_vae"))))
    finally:
        ridge.extract_block_features = extract
    vit, images01, cfg, last = taps.pop("in")
    depth = cfg.depth
    check(len(mses) == depth and all(math.isfinite(v) for v in mses.values()),
          f"search: {len(mses)} MSEs {mses}")
    check(best == min(mses, key=mses.get), f"search: best {best} of {mses}")
    kshape = (cfg.embed_dim, 16, 5, 3, 3)
    for k in range(1, depth + 1):
        art = ckpt.load_search_artifact(out / f"state_dict_enc_blocks_{k}.npz")
        check(art["kernel"].shape == kshape and art["bias"].shape
              == (cfg.embed_dim,) and np.isfinite(art["kernel"]).all(),
              f"search: enc_blocks_{k} artifact {art['kernel'].shape}")
        check((out / f"mse_enc_blocks_{k}.txt").is_file(),
              f"search: mse_enc_blocks_{k}.txt")
    # the last block's tap is the trunk's own output before the norm
    with torch.no_grad():
        mean = images01.new_tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1)
        std = images01.new_tensor(IMAGENET_STD).reshape(1, 3, 1, 1)
        imgs = (images01 - mean) / std
        x = vit_mod.prepare_tokens(vit, vit.patch_proj(imgs), (
            imgs.shape[-2] // cfg.patch_size,
            imgs.shape[-1] // cfg.patch_size), cfg).to(vit.cls_token.dtype)
        for blk in vit.blocks.values():
            x = blk(x)
        own = x[:, 1 + cfg.num_register_tokens:].to(torch.float16)
    check(torch.equal(own, last), "search: the last tap is not the trunk's "
          "output before the norm")
    del vit, images01, last, x, own, imgs
    if want_launches is not None:
        check(info["launches"] == want_launches,
              f"search: launches {info['launches']}, want {want_launches}")
    cache = (out / "features.npz").stat().st_size
    (best2, mses2), info2 = measured_main(
        "find_layer.main (cached)", find_layer.main, args, device=device,
        timed=((ridge, ("extract_block_features",
                        "fit_conv3d_streaming")),))
    check(best2 == best and mses2 == mses
          and not any(info2["calls"].values()),
          f"search: the cached run gave {best2} {mses2}, calls "
          f"{info2['calls']}")
    log(f"workflows: search: best {best} (MSE {mses[best]:.6g}), MSEs "
        + json.dumps({k: round(v, 6) for k, v in mses.items()})
        + f"; extraction {sum(info['calls']['extract_block_features']):.1f}"
        f" s, host fit {sum(info['calls']['fit_conv3d_streaming']):.1f} s, "
        f"feature cache {cache} B; the cached run {info2['seconds']:.1f} s")
    return {"best": best, "mses": mses, "info": info, "cached": info2,
            "cache_bytes": cache}


def drive_distillation(src: dict, root: Path, data: dict, search: Path,
                       out: Path, scfg, flags: tuple, *, device: str,
                       want_per_step: dict | None,
                       launcher: bool = False) -> dict:
    """`cli/train_stitching.py::main` from the search's artifact at the
    chop (converted to the {weight, bias} `.pth` the main reads), its
    checks, and on the card that it leaves nothing allocated; returns the
    times, the losses and the launches."""
    import torch

    from vist3a_tpu_torch.cli import arguments, model_loading
    from vist3a_tpu_torch.cli import train_stitching as cli
    from vist3a_tpu_torch.io import checkpoints as ckpt
    from vist3a_tpu_torch.train import stitching as st

    # the search writes the JAX package's {kernel, bias} .npz; the main
    # reads the reference's {weight, bias} torch file
    chop = scfg.stitch_layer_index
    art = ckpt.load_search_artifact(search / f"state_dict_enc_blocks_{chop}.npz")
    init = out.parent / f"init_enc_blocks_{chop}.pth"
    torch.save({"weight": torch.from_numpy(art["kernel"]),
                "bias": torch.from_numpy(art["bias"])}, init)
    seed = workflow_seed()
    args = arguments.stitching_training_argument().parse_args([
        "--dataset", f"dl3dv:{data['dl3dv']}",
        "--dataset", f"scannet:{data['scannet']}",
        "--stitching_layer_location", f"enc_blocks_{chop}",
        "--stitching_layer_config", scfg.conv_spec,
        "--initialization_weight_path", str(init),
        "--lora_config", TRAIN_LORA, "--num_epochs", "1",
        "--batch_size", "1", "--save_path", str(out), "--wandb_logging",
        "--global_seed", str(seed), *flags])
    args.weights_root = str(root)
    store = {}
    with captured(cli, "run", store):
        (state, history), info = measured_main(
            "train_stitching.main", cli.main, args, device=device,
            timed=((st, ("stitch_train_step",)),
                   (model_loading, ("load_anysplat_encoder",
                                    "load_wan_vae"))), launcher=launcher)
    params = store.pop("run")[0][0]
    n_steps = len(WORKFLOW_STITCH_VIEWS)
    check(state.step == n_steps and len(history) == 1,
          f"distillation: {state.step} steps, history {len(history)}")
    check(history[0]["views"] == WORKFLOW_STITCH_VIEWS[0],
          f"distillation: step 0 took {history[0]['views']} views")
    check(all(math.isfinite(v) for k, v in history[0].items()
              if isinstance(v, float)), f"distillation: {history[0]}")
    stream = [json.loads(line) for line in (
        out / f"{args.exp_name}.metrics.jsonl").read_text().splitlines()]
    # the 14 terms, their total and grad_norm (and the step's lr)
    terms = [k for k in history[0] if k not in ("epoch", "step", "views",
                                                "lr")]
    check(len(stream) == 1 and len(terms) == 16
          and all(math.isfinite(stream[0][k]) for k in terms + ["lr"]),
          f"distillation: metric stream {stream} (terms {terms})")
    saved = out / "stitched_model_epoch_0.pt"
    check(saved.is_file() and saved.stat().st_size > 0,
          f"distillation: {saved} missing")
    n_teacher = same_values("distillation: teacher",
                            params["encoder"].state_dict(),
                            src["encoder"].state_dict())
    conv = params["stitch_conv"].state_dict()
    check(torch.equal(conv["weight"].cpu(), torch.from_numpy(art["kernel"]))
          and torch.equal(conv["bias"].cpu(), torch.from_numpy(art["bias"])),
          "distillation: the stitch conv is not the search's artifact")
    del params, state, conv
    info["left_bytes"] = left_behind("train_stitching.main",
                                     info["start_bytes"], device == "cuda")
    if want_per_step is not None:
        want = {k: n_steps * v for k, v in want_per_step.items()}
        got = {k: info["launches"][k] for k in want}
        check(got == want, f"distillation: launches {got}, want {want}")
    log(f"workflows: distillation: {n_steps} steps (views "
        f"{list(WORKFLOW_STITCH_VIEWS)}, seed {seed}), step s "
        f"{[round(x, 2) for x in info['calls']['stitch_train_step']]}, "
        f"losses " + json.dumps({k: round(history[0][k], 6)
                                 for k in terms})
        + f"; the teacher's {n_teacher} tensors unchanged; "
        f"{saved.name} {saved.stat().st_size} B")
    return {"info": info, "seed": seed, "history": history}


def drive_vdm(src: dict, root: Path, written: dict, data: dict, out: Path,
              scfg, flags: tuple, *, tokenize, device: str,
              want_launches: bool, grid_tiles: tuple,
              launcher: bool = False) -> dict:
    """`cli/train_vdm.py::main --enable_rl` for one step, its checks
    (`grid_tiles`: the image grid's (rows, columns) of square tiles: the
    decoded frame and the 13 renders, 7 a row);
    returns the times, the losses and the launches."""
    import cv2
    import numpy as np
    import torch

    from vist3a_tpu_torch.cli import arguments, model_loading
    from vist3a_tpu_torch.cli import train_vdm as cli
    from vist3a_tpu_torch.cli import inference_t23d
    from vist3a_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from vist3a_tpu_torch.nn import clip as clip_mod
    from vist3a_tpu_torch.stitch.lora import parse_lora_mode
    from vist3a_tpu_torch.train import reward, vdm

    args = arguments.training_vdm_argument().parse_args([
        "--enable_rl", "--dataset", f"dl3dv:{data['dl3dv']}",
        "--text_dataset_path", str(data["prompts"]),
        "--checkpoint_path", str(root / "anysplat_stitched.pth"),
        "--stitching_layer_location", f"enc_blocks_{scfg.stitch_layer_index}",
        "--stitching_layer_config", scfg.conv_spec,
        "--lora_config", TRAIN_LORA, "--num_epochs", "1",
        "--save_freq", "1", "--save_path", str(out), *flags])
    args.weights_root = str(root)
    args.text_annotation_path = str(data["captions"])
    store = {}
    with captured(cli, "run", store), \
            captured(cli, "build_reward_fns", store), \
            captured(reward, "make_loss_fn", store):
        (state, history), info = measured_main(
            "train_vdm.main", lambda a, device: cli.main(
                a, tokenize, device=device), args, device=device,
            timed=((vdm, ("vdm_train_step",)),
                   (model_loading, ("load_stitched_model", "load_wan_vae")),
                   (inference_t23d, ("load_generator",)),
                   (cli, ("build_reward_fns",))), launcher=launcher)
    run_args, run_kw, _ = store.pop("run")
    loss_fn, text_fn = store.pop("build_reward_fns")[2]
    pick, pe = store.pop("make_loss_fn")[0][:2]
    h = history[0]
    check(state.step == 1 and len(history) == 1 and not h["skipped"],
          f"vdm main: step {state.step}, history {history}")
    losses = {k: h[k] for k in ("diffusion_loss", "reward_loss",
                                "total_loss", "grad_norm")}
    check(all(math.isfinite(v) for v in losses.values())
          and h["reward_loss"] != 0 and h["grad_norm"] > 0,
          f"vdm main: {losses}")
    check(h["num_steps"] == vdm.VDMTrainConfig().rollout_steps_high,
          f"vdm main: step 0 rolled out {h['num_steps']} steps")
    if want_launches:
        want = vdm_launches(h["num_steps"], run_args[1].cfg.num_layers)
        check(info["launches"] == want,
              f"vdm main: launches {info['launches']}, want {want}")
    # the per-prompt text features of the imported text towers: finite,
    # unit norm, and those of the source towers on the same ids
    tok = CLIPTokenizer.from_files(str(root / "pickscore" / "vocab.json"),
                                   str(root / "pickscore" / "merges.txt"))
    prompt = h["prompt"]
    norms = []
    for feats, name, pad in zip(text_fn(prompt), ("pick_text", "pe_text"),
                                ("eos", "zero")):
        tower = src[name].to(device)
        ids = torch.from_numpy(tok([prompt], tower.cfg.context_length,
                                   pad=pad))
        with torch.no_grad():
            want_feats = clip_mod.text_features(tower, ids)
        src[name].to("cpu")
        norms.append(float(feats.norm()))
        check(bool(torch.isfinite(feats).all())
              and abs(norms[-1] - 1) < 1e-5 and torch.equal(feats,
                                                            want_feats),
              f"vdm main: {name} features of '{prompt}' (norm "
              f"{norms[-1]})")
    # the frozen modules: as written, after the step
    dit, vae_enc, vae_dec, stitched = run_args[1:5]
    ck = written["checkpoint"]
    # under `--dit_sharding fsdp` the DiT's weights are FSDP2 shards: at
    # world 1 each holds the whole tensor
    n_frozen = {
        "dit": same_values("vdm main: DiT", {
            k: v.to_local() if hasattr(v, "to_local") else v
            for k, v in dit.state_dict().items()}, src["dit"].state_dict()),
        "vae": same_values("vdm main: VAE", {
            "e": vae_enc.state_dict(), "d": vae_dec.state_dict()}, {
            "e": src["vae_encoder"].state_dict(),
            "d": src["vae_decoder"].state_dict()}),
        "stitched": same_values("vdm main: stitched decoder",
                                stitched.state_dict(), expected_stitched(
                                    stitched, src, written,
                                    parse_lora_mode(TRAIN_LORA), ck)),
        "scorers": same_values("vdm main: scorer vision towers", {
            "pick": pick.state_dict(), "pe": pe.state_dict()}, {
            "pick": src["pick_vision"].state_dict(),
            "pe": src["pe_vision"].state_dict()})}
    # the reward loss holds both scorer towers (~5 GB in fp32)
    del run_args, run_kw, dit, vae_enc, vae_dec, stitched, pick, pe, text_fn
    del loss_fn, state
    info["left_bytes"] = left_behind("train_vdm.main", info["start_bytes"],
                                     device == "cuda")
    lines = (out / "history.jsonl").read_text().splitlines()
    check(len(lines) == 1 and json.loads(lines[0])["step"] == 1,
          f"vdm main: history.jsonl {lines}")
    grid = cv2.imread(str(out / "images" / "step_000000.png"))
    rows, cols = grid_tiles
    check(grid is not None and grid.shape[0] * cols == grid.shape[1] * rows
          and grid.shape[0] % rows == 0 and np.ptp(grid) > 0,
          f"vdm main: image grid {None if grid is None else grid.shape}, "
          f"want {rows} × {cols} square tiles")
    files = sorted(p.name for p in (out / "checkpoint-1").iterdir())
    check("meta.json" in files, f"vdm main: checkpoint-1 holds {files}")
    log(f"workflows: vdm main: rollout {h['num_steps']}, step s "
        f"{[round(x, 2) for x in info['calls']['vdm_train_step']]}, "
        + json.dumps(losses) + f"; text feature norms {norms}; frozen "
        f"tensors unchanged {n_frozen}; history.jsonl, images/"
        f"step_000000.png {grid.shape}, checkpoint-1 {files}")
    return {"info": info, "history": history}


def drive_workflows(src: dict, scfg, tmp: Path, *, tokenize,
                    device: str = "cuda", scene_kw: dict | None = None,
                    search_flags: tuple = (), stitch_flags: tuple = (),
                    vdm_flags: tuple = (), want_launches: bool = False,
                    grid_tiles: tuple = (2, 7), launcher: bool = False) -> dict:
    """The three workflows' mains on one weights root and one scene tree
    under `tmp`: the reference-format files of the source modules `src`
    (on the host, the scorers' towers included), the scenes, then the
    search, the distillation from its artifact at the chop, and one VDM
    step, each with its checks.  `*_flags` are added to each command line
    (the CPU test's sizes); `want_launches` checks each main's kernel
    launches (on the card); `launcher` runs the distillation and VDM mains
    under a one-rank torchrun's environment (`measured_main`)."""
    import torch

    from vist3a_tpu_torch.stitch.lora import parse_lora_mode

    root = tmp / "weights"
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    written = write_weights_root(root, src, scfg, parse_lora_mode(TRAIN_LORA),
                                 torch.Generator().manual_seed(41))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = write_scenes(tmp / "data", **(scene_kw or {}))
    scenes_s = time.perf_counter() - t0
    log(f"workflows: files written in {write_s:.1f} s "
        f"({json.dumps(written['bytes'])} B), scenes in {scenes_s:.1f} s")
    per_step = TRAIN_LAUNCHES if want_launches else None
    search = drive_search(
        root, data, tmp / "search", scfg, search_flags, device=device,
        want_launches={"unmasked": WORKFLOW_SEARCH_SAMPLES
                       * scfg.encoder.vit.depth, **{
                           k: 0 for k in ("masked", "natural", "backward",
                                          "backward_bf16",
                                          "backward_natural", "composite",
                                          "composite_backward",
                                          "qk_prologue")}}
        if want_launches else None)
    distill = drive_distillation(src, root, data, tmp / "search",
                                 tmp / "stitching", scfg, stitch_flags,
                                 device=device, want_per_step=per_step,
                                 launcher=launcher)
    tuned = drive_vdm(src, root, written, data, tmp / "vdm", scfg, vdm_flags,
                      tokenize=tokenize, device=device,
                      want_launches=want_launches, grid_tiles=grid_tiles,
                      launcher=launcher)
    return {"write_s": write_s, "scenes_s": scenes_s,
            "bytes": written["bytes"], "search": search,
            "distillation": distill, "vdm": tuned}


def build_scorer_sources(gen) -> dict:
    """The two scorers' towers (PickScore: CLIP-H/14 at 224²; DFN5B:
    CLIP-H/14 at 378²; each with a CLIP-H text tower), fp32, random
    weights drawn on the card from `gen`, moved to the host."""
    from vist3a_tpu_torch.nn import clip

    out = {}
    for name, fn, cfg in (("pick_vision", clip.init, clip.CLIP_H_224),
                          ("pick_text", clip.text_init, clip.CLIP_H_TEXT),
                          ("pe_vision", clip.init, clip.DFN5B_H_378),
                          ("pe_text", clip.text_init, clip.CLIP_H_TEXT)):
        out[name] = fn(cfg, gen, device="cuda").to("cpu")
    return out


def phase_workflows() -> dict:
    """The search, distillation and VDM command lines at full width on
    reference-format files and synthetic scene trees on disk
    (`drive_workflows`); the free disk read first, everything deleted
    after."""
    import torch

    from vist3a_tpu_torch.nn import umt5
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    src = build_cli_sources()
    src.update(build_scorer_sources(
        torch.Generator(device="cuda").manual_seed(43)))
    torch.cuda.empty_cache()
    built_s = time.perf_counter() - t0
    need = sum(p.numel() * p.element_size() for m in src.values()
               for p in m.parameters()) + WORKFLOW_EXTRA_BYTES
    tmp = Path(tempfile.mkdtemp(prefix="vist3a_workflows_"))
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= CLI_DISK_FACTOR * need,
              f"workflows: {free} B free under {tmp}; the files need about "
              f"{need} B (×{CLI_DISK_FACTOR} asked)")
        res = drive_workflows(src, ca.StitchedConfig(), tmp,
                              tokenize=fake_tokenizer(umt5.UMT5_XXL),
                              want_launches=True, launcher=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del src
        torch.cuda.empty_cache()
    res["built_s"] = built_s
    log(f"workflows: sources built in {built_s:.1f} s; mains (s, peak B): "
        + json.dumps({k: (round(res[k]["info"]["seconds"], 1),
                          res[k]["info"]["peak_bytes"])
                      for k in ("search", "distillation", "vdm")}))
    return res


# --------------------------------------------------------------------------- #
# phase `evaluation`: RE10K novel-view synthesis, per-scene refinement        #
# --------------------------------------------------------------------------- #
def write_re10k(folder: Path, *, sequences=EVAL_SEQUENCES,
                frames=EVAL_FRAMES, hw=EVAL_HW) -> dict:
    """A synthetic RE10K test tree written with OpenCV: `seq_XXX/images/
    frame_XXXX.png` (`scene_frame`'s moving blobs), `annotations.json`
    with pixel intrinsics and 3×4 extrinsics on a short arc, and beside
    the tree a `seq_id_map` of every frame.  Returns their paths."""
    import cv2
    import numpy as np

    h, w = hw
    root, ids = folder / "re10k", {}
    for s in range(sequences):
        seq = f"seq_{s:03d}"
        (root / seq / "images").mkdir(parents=True)
        annos = []
        for i in range(frames):
            name = f"images/frame_{i:04d}.png"
            ok = cv2.imwrite(str(root / seq / name),
                             scene_frame(i, hw, 60 + s)[:, :, ::-1])
            check(ok, f"evaluation: cv2 could not write {root / seq / name}")
            a = 0.02 * (i - frames / 2)          # yaw (rad) round a point
            c2w = np.eye(4)                      # 2 units ahead
            c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                           [-math.sin(a), 0, math.cos(a)]]
            c2w[:3, 3] = [-2 * math.sin(a), 0, 2 * (1 - math.cos(a))]
            annos.append({"idx": i, "filepath": f"{seq}/{name}",
                          "intrinsics": [[0.9 * w, 0, w / 2],
                                         [0, 0.9 * w, h / 2], [0, 0, 1]],
                          "extrinsics": c2w[:3].tolist()})
        (root / seq / "annotations.json").write_text(json.dumps(annos))
        ids[seq] = list(range(frames))
    (folder / "seq_id_map.json").write_text(json.dumps(ids))
    return {"root": root, "seq_id_map": folder / "seq_id_map.json"}


def read_png(path):
    """(H, W, 3) uint8 RGB through OpenCV."""
    import cv2

    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    check(bgr is not None, f"evaluation: cannot read {path}")
    return bgr[:, :, ::-1]


def host_metrics(images_dir: Path) -> dict:
    """Each sequence's mean PSNR and SSIM over its gt / pred PNGs, in
    float64 numpy in this script (skimage's Gaussian-weighted SSIM: an 11-tap window
    of σ 1.5, 'valid', C1 = 0.01², C2 = 0.03²), independent of the port."""
    import numpy as np

    r = np.arange(11) - 5.0
    win = np.exp(-r ** 2 / (2 * 1.5 ** 2))
    win /= win.sum()

    def filt(a):
        h, w = a.shape[-2:]
        a = sum(win[j] * a[..., j:j + h - 10, :] for j in range(11))
        return sum(win[j] * a[..., :, j:j + w - 10] for j in range(11))

    out = {}
    for seq in sorted(p for p in images_dir.iterdir() if p.is_dir()):
        psnr, ssim = [], []
        for gt_path in sorted((seq / "gt").glob("*.png")):
            x = read_png(gt_path).transpose(2, 0, 1) / 255.0
            y = read_png(seq / "pred" / gt_path.name).transpose(2, 0, 1) \
                / 255.0
            psnr.append(-10.0 * np.log10(np.mean((x - y) ** 2)))
            ux, uy = filt(x), filt(y)
            vx, vy = filt(x * x) - ux * ux, filt(y * y) - uy * uy
            vxy = filt(x * y) - ux * uy
            c1, c2 = 0.01 ** 2, 0.03 ** 2
            ssim.append(np.mean((2 * ux * uy + c1) * (2 * vxy + c2)
                                / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))))
        out[seq.name] = {"psnr": float(np.mean(psnr)),
                         "ssim": float(np.mean(ssim))}
    return out


def check_metric_files(out_dir: Path, seqs: list, targets: int) -> dict:
    """The PNGs and CSVs `nvs_eval.main` wrote, the CSV's PSNR and SSIM
    finite and equal to this script's float64 recomputation from the PNGs.
    Returns the CSV rows, the host's figures and the largest gaps."""
    import csv

    import numpy as np

    images = out_dir / "images"
    for seq in seqs:
        for kind in ("gt", "pred"):
            n = len(list((images / seq / kind).glob("*.png")))
            check(n == targets, f"evaluation: {seq}/{kind}: {n} PNGs")
    with open(out_dir / "per_sequence.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    with open(out_dir / "overall.csv", newline="") as f:
        overall = list(csv.DictReader(f))
    check([r["sequence"] for r in rows] == seqs and len(overall) == 1,
          f"evaluation: CSV rows {rows}, overall {overall}")
    host = host_metrics(images)
    gap = {"psnr": 0.0, "ssim": 0.0}
    for r in rows:
        for k in gap:
            v = float(r[k])
            check(math.isfinite(v), f"evaluation: {r['sequence']} {k} {v}")
            gap[k] = max(gap[k], abs(v - host[r["sequence"]][k]))
        log(f"evaluation: {r['sequence']}: CSV psnr {r['psnr']} ssim "
            f"{r['ssim']}; host float64 {json.dumps(host[r['sequence']])}")
    check(gap["psnr"] <= EVAL_PSNR_ATOL and gap["ssim"] <= EVAL_SSIM_ATOL,
          f"evaluation: CSV vs host float64 {gap} (limits {EVAL_PSNR_ATOL} "
          f"dB, {EVAL_SSIM_ATOL})")
    for k in gap:
        mean = float(np.mean([float(r[k]) for r in rows]))
        check(abs(float(overall[0][k]) - mean) <= 1e-12 * max(1, abs(mean)),
              f"evaluation: overall {k} {overall[0][k]} vs {mean}")
    return {"rows": rows, "host": host, "gap": gap}


def lpips_card_vs_host(images_dir: Path, seq: str) -> dict:
    """LPIPS of one sequence's PNGs with seeded random VGG16 weights, on
    the card and on the host CPU (the same weights and inputs)."""
    import numpy as np
    import torch

    from vist3a_tpu_torch.eval import metrics

    pngs = sorted((images_dir / seq / "gt").glob("*.png"))

    def stack(kind):
        return torch.from_numpy(np.stack([
            read_png(images_dir / seq / kind / p.name).transpose(2, 0, 1)
            for p in pngs]).astype(np.float32) / 255.0)
    gt, pred = stack("gt"), stack("pred")
    model = metrics.lpips_init(
        torch.Generator(device="cuda").manual_seed(EVAL_LPIPS_SEED))
    t0 = time.perf_counter()
    card = metrics.compute_lpips(model, gt.cuda(), pred.cuda()).cpu()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = metrics.compute_lpips(copy.deepcopy(model).to("cpu"), gt, pred)
    rel = float((card - host).abs().max() / host.abs().max())
    check(torch.isfinite(card).all() and bool((host > 0).all())
          and rel <= EVAL_LPIPS_RTOL,
          f"evaluation: LPIPS card {card.tolist()} host {host.tolist()} "
          f"(rel {rel}, limit {EVAL_LPIPS_RTOL})")
    return {"card": card.tolist(), "host": host.tolist(), "rel": rel,
            "card_s": card_s}


def refine_context(out, ff_pm1, n_src: int, steps: int, *, device: str
                   ) -> dict:
    """`train/post_opt.py::refine` of pass 1's Gaussians (`out`, from the
    feed-forward frames `ff_pm1` (1, 3, S, h, w) in [−1, 1]) against its
    first `n_src` views (the context, without the duplicate) with their
    poses and intrinsics, `steps` steps of the deployed config; checks
    finite losses that fall (the mean of the last 10 below the mean of the
    first 5) and, on the card, one composite launch each way a step."""
    import torch

    from vist3a_tpu_torch.train import post_opt

    images = (ff_pm1[0, :, :n_src].float() + 1.0) / 2.0
    images = images.permute(1, 2, 3, 0)                     # (V, h, w, 3)
    c2w = out.extrinsic_c2w[0, :n_src].float()
    k = out.intrinsic_norm[0, :n_src].float()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = post_opt.refine(out.gaussians, images, c2w, k, POST_OPT_SEED,
                          post_opt.PostOptConfig(max_steps=steps),
                          device=device)
    sync()
    seconds = time.perf_counter() - t0
    counts = _vdm_counts()
    losses = res.losses
    early, late = float(losses[:5].mean()), float(losses[-10:].mean())
    check(bool(torch.isfinite(losses).all()) and late < early,
          f"evaluation: post-opt losses {losses.tolist()}")
    if cuda:
        want = {"composite": steps, "composite_backward": steps}
        got = {k: counts[k] for k in want}
        check(got == want, f"evaluation: post-opt launches {got}, want "
              f"{want}")
    info = {"steps": steps, "seconds": seconds, "step_s": seconds / steps,
            "gaussians": int(out.gaussians.means.shape[1]),
            "live": int((out.gaussians.opacities[0] > 0.01).sum()),
            "views": n_src, "early": early, "late": late,
            "ratio": late / early, "losses": losses.tolist(),
            "launches": counts,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda
            else None}
    log(f"evaluation: post-opt {steps} steps over {info['gaussians']} "
        f"Gaussians ({info['live']} above the prune) and {n_src} views: "
        f"{seconds:.2f} s ({info['step_s'] * 1e3:.1f} ms a step); loss "
        f"first 5 {early:.6f}, last 10 {late:.6f} (ratio "
        f"{info['ratio']:.4f}); launches {counts}; peak "
        f"{info['peak_bytes']} B")
    return info


def drive_evaluation(src: dict, scfg, tmp: Path, *, device: str = "cuda",
                     frames: int = EVAL_FRAMES, hw=EVAL_HW, flags: tuple = (),
                     want_launches: dict | None = None,
                     refine_steps: int = POST_OPT_STEPS) -> dict:
    """Write the reference-format files `nvs_eval.main` reads from the
    source modules `src` (on the host: the AnySplat encoder and the Wan
    VAE; a stitched checkpoint chopped at the config's layer) and a
    synthetic RE10K tree under `tmp`, run `cli/nvs_eval.py::main`, check
    what it wrote (`check_metric_files`) and its launches, then refine its
    first sequence's pass-1 Gaussians (`refine_context`).  `flags` are
    added to the command line (the CPU test's sizes)."""
    import torch

    from vist3a_tpu_torch.cli import arguments, model_loading, nvs_eval
    from vist3a_tpu_torch.eval import nvs, re10k
    from vist3a_tpu_torch.nn import wan_vae
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca
    from vist3a_tpu_torch.stitch.conv_spec import conv_spec_to_string
    from vist3a_tpu_torch.stitch.lora import parse_lora_mode

    root = tmp / "weights"
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    written = write_weights_root(root, src, scfg, parse_lora_mode(EVAL_LORA),
                                 torch.Generator().manual_seed(61))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = write_re10k(tmp / "data", frames=frames, hw=hw)
    scenes_s = time.perf_counter() - t0
    log(f"evaluation: files written in {write_s:.1f} s "
        f"({json.dumps(written['bytes'])} B), scenes in {scenes_s:.1f} s")
    out_dir = tmp / "results"
    args = arguments.stitching_nvs_evaluation_argument().parse_args([
        "--dataset", f"re10k:{data['root']}",
        "--seq_id_map", str(data["seq_id_map"]),
        "--checkpoint_path", str(root / "anysplat_stitched.pth"),
        "--stitching_layer_location", f"enc_blocks_{scfg.stitch_layer_index}",
        "--stitching_layer_config", conv_spec_to_string(scfg.conv),
        "--lora_config", EVAL_LORA,
        "--resolution", str(EVAL_RESOLUTION),
        "--feedforward_resolution", str(EVAL_FF_RESOLUTION),
        "--output_dir", str(out_dir), *flags])
    args.weights_root = str(root)
    store = {}
    with captured(ca, "forward_from_video", store, first=True):
        (modules, result), info = measured_main(
            "nvs_eval.main", nvs_eval.main, args, device=device,
            phase="evaluation", timed=(
                (model_loading, ("load_stitched_model",)),
                (re10k.Re10KNVSDataset, ("get_data",)),
                (wan_vae, ("encode",)), (ca, ("forward_with_latent",)),
                (nvs, ("render", "save_image", "compute_metrics_for_dir"))))
    check(sorted(modules) == ["stitched", "vae_encoder"],
          f"evaluation: main loaded {sorted(modules)}")
    n_vae = same_values("VAE encoder", modules["vae_encoder"].state_dict(),
                        {k: v.float() for k, v in
                         src["vae_encoder"].state_dict().items()})
    del modules
    seqs = sorted(json.loads(data["seq_id_map"].read_text()))
    if want_launches is not None:
        got = {k: info["launches"][k] for k in want_launches}
        check(got == want_launches, f"evaluation: launches {got}, want "
              f"{want_launches}")
    files = check_metric_files(out_dir, seqs, EVAL_TARGETS)
    lpips = (lpips_card_vs_host(out_dir / "images", seqs[0])
             if device == "cuda" else None)
    pass1_args, _, pass1 = store.pop("forward_from_video")
    check(pass1_args[2].shape[2] == frames - EVAL_TARGETS + 1,
          f"evaluation: pass 1 ran {pass1_args[2].shape[2]} frames")
    refined = refine_context(pass1, pass1_args[3], frames - EVAL_TARGETS,
                             refine_steps, device=device)
    log(f"evaluation: overall {json.dumps(result['overall'])}; CSV vs host "
        f"float64 {json.dumps(files['gap'])}; LPIPS card vs host "
        f"{json.dumps(lpips)}")
    return {"write_s": write_s, "scenes_s": scenes_s,
            "bytes": written["bytes"], "info": info, "result": result,
            "files": files, "lpips": lpips, "post_opt": refined,
            "compared": {"vae_encoder": n_vae},
            "pass1_gaussians": int(pass1.gaussians.means.shape[1])}


def narrow_refine_scene():
    """`tests/test_post_opt.py`'s scene in numpy from the same seeds: 48
    Gaussians, three cameras 0.4 apart looking down +z, normalised
    intrinsics."""
    import numpy as np
    import torch

    from vist3a_tpu_torch.nn.gaussians import Gaussians, build_covariance

    rng = np.random.default_rng(7)
    g = 48
    means = rng.normal(0, 0.8, (g, 3)).astype(np.float32)
    means[:, 2] += 4.0
    scales = rng.uniform(0.08, 0.3, (g, 3)).astype(np.float32)
    quats = rng.normal(size=(g, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    harmonics = np.zeros((g, 3, 25), np.float32)
    harmonics[:, :, 0] = rng.uniform(0.2, 1.5, (g, 3))
    opacities = rng.uniform(0.35, 0.95, (g,)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in (
        ("means", means), ("scales", scales), ("quats", quats),
        ("harmonics", harmonics), ("opacities", opacities))}
    gaussians = Gaussians(t["means"][None],
                          build_covariance(t["scales"], t["quats"])[None],
                          t["harmonics"][None], t["opacities"][None],
                          t["scales"][None], t["quats"][None])
    c2w = torch.eye(4).repeat(3, 1, 1)
    c2w[:, 0, 3] = torch.tensor([-0.4, 0.0, 0.4])
    k_norm = torch.tensor([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]]
                          ).repeat(3, 1, 1)
    return gaussians, c2w, k_norm


def narrow_refine_reference() -> dict:
    """`refine` of the narrow scene perturbed (means +N(0, 0.05), SH
    +N(0, 0.15)) against its clean 32² renders, `POST_OPT_NARROW_STEPS`
    steps with pose refinement and both regularisers, the same views
    handed in, on the card and on the host CPU: the losses within
    `POST_OPT_LOSS_RTOL`, every refined parameter within
    `POST_OPT_PARAM_ADAM_SHARE` of its group's Adam travel, the cameras
    within that share of how far they moved."""
    import numpy as np
    import torch

    from vist3a_tpu_torch.kernels import rasterizer as tr
    from vist3a_tpu_torch.train import post_opt

    gaussians, c2w, k_norm = narrow_refine_scene()
    hw = 32
    ks = k_norm * torch.tensor([[hw], [hw], [1.0]])
    g = gaussians
    rgb, _, _ = tr.rasterize(g.means[0], g.covariances[0], g.harmonics[0],
                             g.opacities[0], torch.linalg.inv(c2w), ks, hw,
                             hw, pair_budget=4096)
    target = torch.clamp(rgb, 0.0, 1.0)
    rng = np.random.default_rng(3)
    start = g._replace(
        means=g.means + torch.from_numpy(
            rng.normal(0, 0.05, g.means.shape).astype(np.float32)),
        harmonics=g.harmonics + torch.from_numpy(
            rng.normal(0, 0.15, g.harmonics.shape).astype(np.float32)))
    cfg = post_opt.PostOptConfig(
        max_steps=POST_OPT_NARROW_STEPS, lr_pose=1e-3, opacity_reg=0.01,
        scale_reg=0.01, pair_budget=4096)
    views = POST_OPT_NARROW_VIEWS
    _reset_counts()
    card = post_opt.refine(start, target, c2w, k_norm, 0, cfg, views=views,
                           device="cuda")
    counts = {k: _vdm_counts()[k] for k in ("composite",
                                            "composite_backward")}
    host = post_opt.refine(start, target, c2w, k_norm, 0, cfg, views=views,
                           device="cpu")
    loss_rel = float((card.losses - host.losses).abs().max()
                     / host.losses.abs().max())
    cs, _ = post_opt.splats_from_gaussians(card.gaussians)
    hs, _ = post_opt.splats_from_gaussians(host.gaussians)
    lr = {"means": cfg.lr_means, "scales": cfg.lr_scales,
          "quats": cfg.lr_quats, "opacities": cfg.lr_opacities,
          "sh0": cfg.lr_sh, "shN": cfg.lr_sh / 20}
    share = {k: float((cs[k].cpu() - hs[k]).abs().max()
                      / (lr[k] * cfg.max_steps)) for k in hs}
    moved = float((host.c2w_refined - c2w).abs().max())
    pose_share = float((card.c2w_refined.cpu() - host.c2w_refined).abs()
                       .max()) / moved
    res = {"losses_card": card.losses.tolist(),
           "losses_host": host.losses.tolist(), "loss_rel": loss_rel,
           "param_share": share, "pose_share": pose_share,
           "launches": counts}
    log(f"evaluation: narrow refine card vs host CPU {json.dumps(res)}")
    check(counts == {"composite": cfg.max_steps,
                     "composite_backward": cfg.max_steps},
          f"evaluation: narrow refine launches {counts}")
    check(loss_rel <= POST_OPT_LOSS_RTOL
          and max(share.values()) <= POST_OPT_PARAM_ADAM_SHARE
          and pose_share <= POST_OPT_PARAM_ADAM_SHARE,
          f"evaluation: narrow refine card vs host CPU: {res}")
    return res


def phase_evaluation() -> dict:
    """`cli/nvs_eval.py::main` at full width on reference-format files and
    a synthetic RE10K tree (`drive_evaluation`; the free disk read first,
    everything deleted after), the post-optimisation of its first scene,
    then the narrow refine card vs host CPU."""
    import torch

    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    src = build_cli_sources(generator=False)
    built_s = time.perf_counter() - t0
    need = sum(p.numel() * p.element_size() for m in src.values()
               for p in m.parameters()) * 2
    tmp = Path(tempfile.mkdtemp(prefix="vist3a_evaluation_"))
    per_seq = {**EVAL_LAUNCHES_PER_SEQUENCE, **{
        k: 0 for k in ("natural", "backward", "backward_bf16",
                       "backward_natural", "composite_backward")}}
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= CLI_DISK_FACTOR * need,
              f"evaluation: {free} B free under {tmp}; the files need about "
              f"{need} B (×{CLI_DISK_FACTOR} asked)")
        res = drive_evaluation(
            src, ca.StitchedConfig(), tmp,
            want_launches={k: EVAL_SEQUENCES * v for k, v in per_seq.items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del src
        torch.cuda.empty_cache()
    check(res["pass1_gaussians"] == (EVAL_FRAMES - EVAL_TARGETS + 1)
          * EVAL_FF_RESOLUTION ** 2,
          f"evaluation: pass 1 gave {res['pass1_gaussians']} Gaussians")
    res["narrow"] = narrow_refine_reference()
    res["built_s"] = built_s
    info = res["info"]
    # the kernels line's path: the main's launches and the refinement's
    res["launches"] = {k: info["launches"][k]
                       + res["post_opt"]["launches"][k]
                       for k in info["launches"]}
    log(f"evaluation: sources built in {built_s:.1f} s; main "
        f"{info['seconds']:.1f} s (read {info['read_s']:.1f} s), peak "
        f"{info['peak_bytes']} B; calls (s) " + json.dumps(
            {n: [round(x, 3) for x in v] for n, v in info["calls"].items()})
        + f"; pass 1 {res['pass1_gaussians']} Gaussians; launches "
        f"{json.dumps(res['launches'])}")
    return res


# --------------------------------------------------------------------------- #
# phase `generation`: the generation-quality evaluation from its command line #
# --------------------------------------------------------------------------- #
# the special tokens of the Qwen2.5-VL tokenizer that the chat template
# spells (the stand-in tokenizer gives them their ids)
QWEN_SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645,
                 "<|vision_start|>": 151652, "<|vision_end|>": 151653,
                 "<|image_pad|>": 151655}
QWEN_WORDS = 151643             # the ids below the special tokens
GEN_SEED = 71
GEN_NUM_FRAMES = 8              # `gen_eval t3`'s default --num_frames
GEN_DPG_FRAMES = 2
GEN_UR_TOKENS = 64              # the unified-reward call (deployed: 1,024)
GEN_JUDGE_SHARDS = 4
# DPG-Bench questions a prompt: (question, keyword tuple, dependency); the
# second depends on the first
GEN_DPG_QUESTIONS = (
    ("is there {what}?", "entity - whole ({what})", "0"),
    ("is {what} in the centre of the view?",
     "relation - spatial ({what}, centre)", "1"),
    ("is the scene seen in daylight?", "global - lighting (daylight)", "0"))
GEN_SCORE_RTOL = 1e-4           # CLIP, aesthetic, MUSIQ: card vs host, fp32
GEN_TINY_LOGITS_RTOL = 1e-4     # the tiny judge, fp32, of the largest logit
# the full-width judge cut to 2 vision blocks and 2 text layers, bf16 on the
# card against fp32 on the host: the prefill logits' largest difference over
# their largest magnitude (0.0152 at the first run on the card, ~3× that)
GEN_NARROW_LOGITS_RTOL = 0.05
GEN_EXTRA_BYTES = 1 << 30


def tiny_judge_configs():
    """`tests/test_qwen_vl.py`'s VCFG / TCFG in the port's classes: 4 vision
    blocks (1 and 3 full attention), 3 decoder layers of 4 query and 2 kv
    heads, a 128-token vocabulary."""
    from vist3a_tpu_torch.nn import qwen_vl

    return (qwen_vl.QwenVLVisionConfig(
        depth=4, hidden_size=64, intermediate_size=128, num_heads=4,
        patch_size=2, spatial_merge_size=2, temporal_patch_size=2,
        tokens_per_second=2, window_size=8, out_hidden_size=48,
        fullatt_block_indexes=(1, 3)),
        qwen_vl.QwenVLTextConfig(
            vocab_size=128, hidden_size=48, intermediate_size=96,
            num_layers=3, num_heads=4, num_kv_heads=2, rope_theta=1e6,
            mrope_section=(2, 2, 2), rms_eps=1e-6, tie_embeddings=False,
            image_token_id=120, video_token_id=121,
            vision_start_token_id=122, eos_token_ids=()))


class StandInQwenTokenizer:
    """A stand-in for the Qwen2.5-VL tokenizer (its files are not in the
    repository, and the card machine has no `transformers`): the chat
    template's special tokens to their ids, every other word or symbol to
    an id below `n_words` seeded by its text.  An answer decodes to "Yes"
    or "No" by the parity of its first id, so a judge with random weights
    answers DPG's questions both ways."""

    def __init__(self, specials: dict, n_words: int):
        import re

        self.specials = dict(specials)
        self.n_words = n_words
        self.pattern = re.compile("|".join(map(re.escape, specials))
                                  + r"|\w+|[^\s\w]")

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [
            self.specials.get(t, zlib.crc32(t.encode()) % self.n_words)
            for t in self.pattern.findall(text)]}

    def decode(self, ids, skip_special_tokens=True):
        special = set(self.specials.values())
        ids = [i for i in ids if not (skip_special_tokens and i in special)]
        return ("Yes" if ids[0] % 2 == 0 else "No") if ids else ""


def qwen_config_json(vcfg, tcfg, dtype: str = "bfloat16") -> dict:
    """A Qwen2.5-VL `config.json` in HF's layout (the text fields at the top
    level, the vision tower's under `vision_config`)."""
    return {
        "architectures": ["Qwen2_5_VLForConditionalGeneration"],
        "model_type": "qwen2_5_vl", "torch_dtype": dtype,
        "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
        "intermediate_size": tcfg.intermediate_size,
        "num_hidden_layers": tcfg.num_layers,
        "num_attention_heads": tcfg.num_heads,
        "num_key_value_heads": tcfg.num_kv_heads,
        "rope_theta": tcfg.rope_theta, "rms_norm_eps": tcfg.rms_eps,
        "rope_scaling": {"type": "mrope",
                         "mrope_section": list(tcfg.mrope_section)},
        "tie_word_embeddings": tcfg.tie_embeddings,
        "image_token_id": tcfg.image_token_id,
        "video_token_id": tcfg.video_token_id,
        "vision_start_token_id": tcfg.vision_start_token_id,
        "eos_token_id": list(tcfg.eos_token_ids),
        "vision_config": {
            "depth": vcfg.depth, "hidden_size": vcfg.hidden_size,
            "intermediate_size": vcfg.intermediate_size,
            "num_heads": vcfg.num_heads, "in_chans": vcfg.in_channels,
            "patch_size": vcfg.patch_size,
            "spatial_merge_size": vcfg.spatial_merge_size,
            "temporal_patch_size": vcfg.temporal_patch_size,
            "tokens_per_second": vcfg.tokens_per_second,
            "window_size": vcfg.window_size,
            "out_hidden_size": vcfg.out_hidden_size,
            "fullatt_block_indexes": list(vcfg.fullatt_block_indexes)}}


def clip_config_json(vcfg, tcfg) -> dict:
    """An HF `CLIPModel` `config.json` for a vision and a text config."""
    return {
        "architectures": ["CLIPModel"], "model_type": "clip",
        "projection_dim": vcfg.projection_dim,
        "vision_config": {
            "hidden_size": vcfg.hidden_size,
            "num_hidden_layers": vcfg.num_layers,
            "num_attention_heads": vcfg.num_heads,
            "intermediate_size": vcfg.mlp_dim,
            "patch_size": vcfg.patch_size, "image_size": vcfg.image_size,
            "hidden_act": vcfg.act, "projection_dim": vcfg.projection_dim},
        "text_config": {
            "hidden_size": tcfg.hidden_size,
            "num_hidden_layers": tcfg.num_layers,
            "num_attention_heads": tcfg.num_heads,
            "intermediate_size": tcfg.mlp_dim,
            "vocab_size": tcfg.vocab_size,
            "max_position_embeddings": tcfg.context_length,
            "hidden_act": tcfg.act, "projection_dim": tcfg.projection_dim}}


def draw_judge(vcfg, tcfg, dtype, device: str = "cuda") -> dict:
    """The Qwen2.5-VL judge's two modules with random weights drawn on
    `device` in `dtype` from `GEN_SEED`: the same values at every call."""
    import torch

    from vist3a_tpu_torch.nn import qwen_vl

    gen = torch.Generator(device=device).manual_seed(GEN_SEED)
    return {"judge_vision": qwen_vl.vision_init(vcfg, gen, device, dtype),
            "judge_text": qwen_vl.text_init(tcfg, gen, device, dtype)}


def build_generation_sources(device: str = "cuda", *, judge=None,
                             clip_cfgs=None, judge_dtype=None) -> dict:
    """The scorers' models with random weights drawn on `device` from
    seeds: the Qwen2.5-VL judge (`draw_judge`; by default the 7B configs
    in bf16), left on `device`, and, moved to the host, CLIP ViT-L/14 and
    LongCLIP-L (each a vision and a text tower, fp32; by default
    `CLIP_L_224`, `CLIP_L_TEXT` and `LONGCLIP_L_TEXT`), the aesthetic
    probe's 768 → 1 head and MUSIQ (fp32, the SPAQ config: the CLI loads
    no other)."""
    import torch

    from vist3a_tpu_torch.eval import musiq, scorers
    from vist3a_tpu_torch.nn import clip, qwen_vl

    cv, ct, lt = clip_cfgs or (scorers.CLIP_L_224, clip.CLIP_L_TEXT,
                               clip.LONGCLIP_L_TEXT)
    src = draw_judge(*(judge or (qwen_vl.QWEN25_VL_7B_VISION,
                                 qwen_vl.QWEN25_VL_7B_TEXT)),
                     judge_dtype or torch.bfloat16, device)
    gen = torch.Generator(device=device).manual_seed(GEN_SEED + 3)
    for name, fn, cfg, dtype in (
            ("clip_vision", clip.init, cv, torch.float32),
            ("clip_text", clip.text_init, ct, torch.float32),
            ("long_vision", clip.init, cv, torch.float32),
            ("long_text", clip.text_init, lt, torch.float32),
            ("musiq", musiq.init, musiq.MUSIQConfig(), torch.float32)):
        src[name] = fn(cfg, gen, device=device, dtype=dtype).to("cpu")
    d = cv.projection_dim
    src["aesthetic"] = {
        "weight": (torch.randn(1, d, generator=gen, device=device)
                   * d ** -0.5).cpu(),
        "bias": torch.randn(1, generator=gen, device=device).cpu()}
    src["logit_scale"] = torch.tensor(math.log(100.0))
    return src


def write_generation_root(root: Path, src: dict, texts) -> dict:
    """The scorers' files in their released layouts under `root`: `judge/`
    (an HF Qwen2.5-VL folder: config.json and `GEN_JUDGE_SHARDS` safetensors
    shards with their index), `clip/` and `longclip/` (HF CLIPModel folders:
    config.json, model.safetensors, a synthetic vocab.json + merges.txt
    spelling `texts`), `aesthetic.npy` ({"weight", "bias"}) and
    `musiq.npz`.  Returns the bytes of each."""
    import numpy as np

    from vist3a_tpu_torch.eval import musiq
    from vist3a_tpu_torch.io import manifests

    out = {}
    judge = root / "judge"
    judge.mkdir(parents=True)
    (judge / "config.json").write_text(json.dumps(qwen_config_json(
        src["judge_vision"].cfg, src["judge_text"].cfg,
        str(src["judge_text"].embed.dtype).split(".")[-1])))
    out["judge"] = write_sharded(judge, manifests._fab_qwen_vl(
        src["judge_vision"], src["judge_text"]), GEN_JUDGE_SHARDS)
    for name, vis, txt in (("clip", "clip_vision", "clip_text"),
                           ("longclip", "long_vision", "long_text")):
        folder = root / name
        folder.mkdir()
        (folder / "config.json").write_text(json.dumps(clip_config_json(
            src[vis].cfg, src[txt].cfg)))
        vocab = write_clip_tokenizer(folder, texts)
        check(vocab <= src[txt].cfg.vocab_size,
              f"generation: {vocab} tokens for a {src[txt].cfg.vocab_size}"
              " vocabulary")
        out[name] = write_safetensors(
            folder / "model.safetensors", manifests._fab_hf_clip_model(
                src[vis], src[txt], src["logit_scale"]))
    np.save(root / "aesthetic.npy", {k: v.numpy() for k, v in
                                     src["aesthetic"].items()})
    musiq.save_musiq_npz(root / "musiq.npz", musiq.params_tree(src["musiq"]))
    for name in ("aesthetic.npy", "musiq.npz"):
        out[name] = (root / name).stat().st_size
    return out


def dpg_csv(path: Path, prompts) -> list:
    """A DPG-Bench CSV: `GEN_DPG_QUESTIONS` for each prompt; returns its
    rows."""
    import csv

    rows = [{"item_id": str(i), "text": p,
             "question": q.format(what=f"the scene of '{p}'"),
             "keyword": k.format(what=p.split()[1] if len(p.split()) > 1
                                 else p),
             "dependency": dep, "proposition_id": str(j + 1)}
            for i, p in enumerate(prompts)
            for j, (q, k, dep) in enumerate(GEN_DPG_QUESTIONS)]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


def dpg_expected(rows: list, answers: list, prompts: list,
                 n_frames: int) -> dict:
    """DPG-Bench's scores recomputed from the judge's recorded answers (in
    call order: prompt, frame, question), written out here apart from
    `eval/gen_eval.py`: per frame a question scores 1 for "Yes", then, in
    question order, one with a parent (other than 0) scoring 0 is zeroed;
    a prompt's score is the mean over questions, then over frames; the
    categories take each question's last-frame answer before zeroing (as
    the reference does).  Also counts the "Yes" answers zeroed."""
    import numpy as np

    it = iter(answers)
    per_prompt, cats, zeroed = [], {}, 0
    for p in prompts:
        qs = [r for r in rows if r["text"] == p]
        frame_scores, orig = [], {}
        for _ in range(n_frames):
            orig = {int(r["proposition_id"]): float(next(it) == "Yes")
                    for r in qs}
            s = dict(orig)
            for r in qs:
                q = int(r["proposition_id"])
                parents = [int(d) for d in r["dependency"].split(",")]
                if any(d != 0 and s.get(d, 1) == 0 for d in parents):
                    zeroed += s[q] == 1.0
                    s[q] = 0
            frame_scores.append(sum(s.values()) / len(s))
        per_prompt.append(sum(frame_scores) / len(frame_scores))
        for r in qs:
            cat = r["keyword"].split("(")[0].strip()
            cats.setdefault(cat, []).append(orig[int(r["proposition_id"])])
    l1 = {}
    for c, v in cats.items():
        l1.setdefault(c.split("-")[0].strip(), []).extend(v)
    return {"dpg_score": float(np.mean(per_prompt) * 100),
            "l1": {k: float(np.mean(v) * 100) for k, v in l1.items()},
            "l2": {k: float(np.mean(v) * 100) for k, v in sorted(cats.items())},
            "zeroed": int(zeroed)}


@contextlib.contextmanager
def judge_timings(store: dict, sync):
    """Wrap `nn/qwen_vl.py`'s `vision_features` and `text_forward`: each
    call's seconds (after `sync()`) go to store["vision"] and, with the
    number of tokens it ran, to store["text"]; restored on exit."""
    from vist3a_tpu_torch.nn import qwen_vl

    saved = qwen_vl.vision_features, qwen_vl.text_forward
    store.setdefault("vision", [])
    store.setdefault("text", [])

    def vision(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = saved[0](*a, **k)
        sync()
        store["vision"].append(time.perf_counter() - t0)
        return out

    def text(model, embeds, *a, **k):
        sync()
        t0 = time.perf_counter()
        out = saved[1](model, embeds, *a, **k)
        sync()
        store["text"].append((embeds.shape[0], time.perf_counter() - t0))
        return out
    qwen_vl.vision_features, qwen_vl.text_forward = vision, text
    try:
        yield store
    finally:
        qwen_vl.vision_features, qwen_vl.text_forward = saved


def judge_summary(store: dict) -> dict:
    """Judge calls from `judge_timings`: the vision tower's, the prefills'
    and the decode steps' ms."""
    import numpy as np

    pre = [s for n, s in store["text"] if n > 1]
    steps = [s for n, s in store["text"] if n == 1]
    return {"calls": len(store["vision"]),
            "vision_ms": [round(s * 1e3, 2) for s in store["vision"]],
            "prefill_tokens": [n for n, _ in store["text"] if n > 1],
            "prefill_ms": [round(s * 1e3, 2) for s in pre],
            "decode_steps": len(steps),
            "ms_per_token": float(np.mean(steps) * 1e3) if steps else None}


def _run_main(label: str, argv: list, *, device: str, tokenizer=None,
              extra=()) -> tuple:
    """`cli/gen_eval.py::main(argv)` with the launch counts reset before
    it, its printed output captured and logged, the peak device memory
    from its start, the seconds reading files and in `extra` ((module,
    names) pairs).  Returns (its result, what it printed, info)."""
    import io

    from vist3a_tpu_torch.cli import gen_eval as cli

    printed = io.StringIO()

    def call(a, device):
        with contextlib.redirect_stdout(printed):
            return cli.main(a, tokenizer, device=device)
    result, info = measured_main(label, call, argv, device=device,
                                 timed=extra, phase="generation")
    log(f"generation: {label} printed {' '.join(printed.getvalue().split())}")
    return result, printed.getvalue(), info


def drive_generation(src: dict, tmp: Path, scenes: Path, *,
                     device: str = "cuda", tokenizer=None,
                     num_frames: int = GEN_NUM_FRAMES,
                     dpg_frames: int = GEN_DPG_FRAMES,
                     ur_tokens: int = GEN_UR_TOKENS) -> dict:
    """Write the scorers' files from the source modules `src` under
    `tmp/weights` (the judge's are dropped from `src` once written, and
    drawn again for the check), then run `cli/gen_eval.py::main` over the
    {prompt.txt, gs.mp4} folders under `scenes`: `t3` with every scorer
    but the judge (random weights never write a parseable score line),
    `dpg` with the judge and `tokenizer` (2 frames a folder, 3 questions a
    prompt, one depending on another), then one unified-reward call on one
    frame with `ur_tokens` new tokens.  Checks the scores, the files, the
    judge's weights as written, the dependency zeroing and that no kernel
    of the repo launched."""
    import numpy as np
    import torch

    from vist3a_tpu_torch.cli import gen_eval as cli
    from vist3a_tpu_torch.eval import gen_eval, qwen_judge

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    folders = gen_eval.discover_prompt_folders(scenes)
    prompts = [p for _, p in folders]
    check(folders, f"generation: no prompt folders under {scenes}")
    root, out = tmp / "weights", tmp / "results"
    root.mkdir(parents=True)
    out.mkdir()
    t0 = time.perf_counter()
    written = write_generation_root(root, src, prompts)
    write_s = time.perf_counter() - t0
    judge_cfgs = (src["judge_vision"].cfg, src["judge_text"].cfg,
                  src["judge_text"].embed.dtype)
    del src["judge_vision"], src["judge_text"]
    if cuda:
        torch.cuda.empty_cache()
    log(f"generation: files written in {write_s:.1f} s "
        f"({json.dumps(written)} B)")

    # t3: CLIPScore, LongCLIP, aesthetic, MUSIQ, each call timed
    t3_path = out / "t3.json"
    scorer_s, build = {}, cli.build_scorers

    def timed_build(*a, **k):
        def timed(name, fn):
            def call(*x):
                sync()
                t0 = time.perf_counter()
                v = fn(*x)
                sync()
                scorer_s.setdefault(name, []).append(time.perf_counter() - t0)
                return v
            return call
        return {n: timed(n, f) for n, f in build(*a, **k).items()}
    cli.build_scorers = timed_build
    try:
        t3, printed, t3_info = _run_main("gen_eval t3", [
            "t3", "--folder_path", str(scenes), "--eval_save_path",
            str(t3_path), "--num_frames", str(num_frames), "--clip_path",
            str(root / "clip"), "--longclip_path", str(root / "longclip"),
            "--aesthetic_probe", str(root / "aesthetic.npy"),
            "--musiq_weights", str(root / "musiq.npz")], device=device,
            extra=((gen_eval, ("sample_video_frames",)),))
    finally:
        cli.build_scorers = build
    check(json.loads(t3_path.read_text()) == t3, "generation: t3 JSON")
    check(json.loads(printed) == t3["summary"],
          "generation: t3 printed summary != the JSON's")
    check([r["prompt"] for r in t3["per_prompt"]] == prompts,
          f"generation: t3 rows {[r['prompt'] for r in t3['per_prompt']]}")
    for row in t3["per_prompt"]:
        scores = {k: row[k] for k in ("clip", "longclip", "aesthetic",
                                      "musiq")}
        check(all(np.isfinite(v) for v in scores.values()),
              f"generation: non-finite {scores}")
        check(all(0.0 <= row[k] <= 100.0 for k in ("clip", "longclip")),
              f"generation: CLIP scores {scores} outside [0, 100]")

    # dpg: the 7B judge's VQA
    csv_path = tmp / "dpg.csv"
    rows = dpg_csv(csv_path, prompts)
    answers, store, timings = [], {}, {}
    make_vqa = qwen_judge.make_vqa_judge

    def recording_vqa(*a, **k):
        vqa = make_vqa(*a, **k)

        def recorded(image, question):
            answers.append(vqa(image, question))
            return answers[-1]
        return recorded
    qwen_judge.make_vqa_judge = recording_vqa
    try:
        with captured(qwen_judge, "load_judge", store), \
                judge_timings(timings, sync):
            dpg, _, dpg_info = _run_main("gen_eval dpg", [
                "dpg", "--folder_path", str(scenes), "--csv", str(csv_path),
                "--res_path", str(out / "dpg.json"), "--num_frames",
                str(dpg_frames), "--model-path", str(root / "judge")],
                device=device, tokenizer=tokenizer,
                extra=((qwen_judge, ("load_judge",)),))
    finally:
        qwen_judge.make_vqa_judge = make_vqa
    check(json.loads((out / "dpg.json").read_text()) == dpg,
          "generation: dpg JSON")
    check(0.0 <= dpg["dpg_score"] <= 100.0,
          f"generation: dpg_score {dpg['dpg_score']}")
    check(len(answers) == len(rows) * dpg_frames,
          f"generation: {len(answers)} judge calls")
    want = dpg_expected(rows, answers, prompts, dpg_frames)
    zeroed = want.pop("zeroed")
    check(want == {k: dpg[k] for k in want},
          f"generation: dpg {dpg} != the recomputation {want}")
    dpg_judge = judge_summary(timings)
    vis, txt, tok, _, _ = store.pop("load_judge")[2]

    # one unified-reward call, cut to `ur_tokens` new tokens
    judge = qwen_judge.make_unified_reward_judge(vis, txt, tok,
                                                 max_new_tokens=ur_tokens)
    frame = gen_eval.sample_video_frames(folders[0][0] / "gs.mp4", 1)[0]
    timings = {}
    _reset_counts()
    with judge_timings(timings, sync):
        t0 = time.perf_counter()
        text = judge([frame], prompts[0])
        sync()
        ur_s = time.perf_counter() - t0
    ur = {**judge_summary(timings), "seconds": ur_s, "answer": text}
    check(_vdm_counts() == dict.fromkeys(_vdm_counts(), 0),
          f"generation: unified reward launched {_vdm_counts()}")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # the loaded judge against the written values, drawn again
    want = draw_judge(*judge_cfgs, device)
    n_judge = sum(same_values(f"judge {k}", m.state_dict(),
                              want[f"judge_{k}"].state_dict())
                  for k, m in (("vision", vis), ("text", txt)))
    del vis, txt, judge, want
    if cuda:
        torch.cuda.empty_cache()
    # the t3 main's scorers run in fp32, the dpg main's judge in bf16
    launches = {"generation_fp32": t3_info["launches"],
                "generation_bf16": dpg_info["launches"]}
    check(all(v == 0 for c in launches.values() for v in c.values()),
          f"generation: the mains launched {launches}")
    return {"write_s": write_s, "bytes": written, "t3": t3,
            "t3_info": t3_info, "scorer_s": scorer_s, "dpg": dpg,
            "dpg_info": dpg_info, "dpg_judge": dpg_judge,
            "dpg_zeroed": zeroed,
            "answers": answers, "unified_reward": ur,
            "judge_tensors_compared": n_judge, "peak_bytes": peak,
            "launches": launches}


def clip_cosines(vision, text_fn, frames, prompt: str):
    """The per-frame cosines of `scorers.make_clip_scorer(vision, text_fn)`
    before its clamp at 0, as a float64 numpy vector."""
    import torch

    from vist3a_tpu_torch.eval import scorers
    from vist3a_tpu_torch.nn import clip as clip_mod

    px = scorers._frames_to_clip_input(frames, vision.cfg.image_size,
                                       vision.patch.device)
    with torch.no_grad():
        img = clip_mod.image_features(vision, px)
    txt = torch.as_tensor(text_fn(prompt)).to(img).reshape(-1)
    return (img @ (txt / torch.linalg.vector_norm(txt))).double().cpu().numpy()


def generation_reference(scenes: Path, root: Path) -> dict:
    """Card against host CPU: (1) the tiny judge of `tiny_judge_configs`
    (fp32): the greedy tokens identical, the logits within
    `GEN_TINY_LOGITS_RTOL` of their largest; (2) the 7B judge cut to 2
    vision blocks (the second full attention) and 2 text layers, bf16 on
    the card and fp32 on the host, on a frame of `scenes`: the prefill's
    last logits within `GEN_NARROW_LOGITS_RTOL`; (3) CLIPScore, LongCLIP,
    the aesthetic score and MUSIQ from the files under `root` on 2 frames,
    fp32 (TF32 off) both sides: within `GEN_SCORE_RTOL`, CLIPScore and
    LongCLIP by their per-frame cosines before the clamp at 0, relative
    to the largest."""
    import numpy as np
    import torch

    from vist3a_tpu_torch.cli import gen_eval as cli
    from vist3a_tpu_torch.eval import gen_eval, qwen_judge, scorers
    from vist3a_tpu_torch.eval.metrics import full_fp32
    from vist3a_tpu_torch.nn import qwen_vl

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max() / b.abs().max())

    res = {}
    folder, prompt = gen_eval.discover_prompt_folders(scenes)[0]
    frames = gen_eval.sample_video_frames(folder / "gs.mp4", 2)
    with full_fp32():
        # (1) the tiny judge
        vcfg, tcfg = tiny_judge_configs()
        gen = torch.Generator().manual_seed(GEN_SEED + 1)
        host = (qwen_vl.vision_init(vcfg, gen, "cpu"),
                qwen_vl.text_init(tcfg, gen, "cpu"))
        card = tuple(copy.deepcopy(m).to("cuda") for m in host)
        grid = (1, 8, 8)
        patches = torch.randn(64, vcfg.patch_dim, generator=gen)
        ids = np.asarray([5, 6, 7, 122] + [120] * 16 + [123, 9, 10, 11, 12])
        pos, delta = qwen_vl.get_rope_index(ids, [grid], tcfg, vcfg)
        out = {}
        for side, (vis, txt), dev in (("host", host, "cpu"),
                                      ("card", card, "cuda")):
            with torch.no_grad():
                img = qwen_vl.vision_features(vis, patches.to(dev), grid)
                emb = qwen_vl.embed_tokens(txt, torch.from_numpy(ids), img)
                logits = qwen_vl.text_forward(txt, emb,
                                              torch.from_numpy(pos))[0]
            out[side] = (logits, qwen_vl.greedy_generate(
                txt, ids, img, pos, delta, max_new_tokens=8))
        res["tiny"] = {"logits_rel": rel(out["card"][0], out["host"][0]),
                       "tokens_card": out["card"][1],
                       "tokens_host": out["host"][1]}
        check(out["card"][1] == out["host"][1]
              and res["tiny"]["logits_rel"] <= GEN_TINY_LOGITS_RTOL,
              f"generation: tiny judge card vs host {res['tiny']}")

        # (2) the full-width judge, cut
        vcfg = dataclasses.replace(qwen_vl.QWEN25_VL_7B_VISION, depth=2,
                                   fullatt_block_indexes=(1,))
        tcfg = dataclasses.replace(qwen_vl.QWEN25_VL_7B_TEXT, num_layers=2)
        gen = torch.Generator(device="cuda").manual_seed(GEN_SEED + 2)
        card = (qwen_vl.vision_init(vcfg, gen, "cuda"),
                qwen_vl.text_init(tcfg, gen, "cuda"))
        host = tuple(copy.deepcopy(m).to("cpu") for m in card)
        card = tuple(m.to(torch.bfloat16) for m in card)
        patches, grid = qwen_judge.preprocess_image(frames[0], vcfg)
        tok = StandInQwenTokenizer(QWEN_SPECIALS, QWEN_WORDS)
        ids = qwen_judge.build_chat_ids(tok, qwen_judge.VQA_WRAPPER.format(
            question=f"is there {prompt}?"), patches.shape[0] // 4)
        pos, _ = qwen_vl.get_rope_index(ids, [grid], tcfg, vcfg)
        out = {}
        for side, (vis, txt), dev in (("host", host, "cpu"),
                                      ("card", card, "cuda")):
            t0 = time.perf_counter()
            with torch.no_grad():
                img = qwen_vl.vision_features(
                    vis, torch.from_numpy(patches).to(dev), grid)
                emb = qwen_vl.embed_tokens(txt, torch.from_numpy(ids), img)
                logits = qwen_vl.text_forward(txt, emb, torch.from_numpy(pos),
                                              last_only=True)[0]
            out[side] = (img, logits, time.perf_counter() - t0)
        res["narrow"] = {"tokens": len(ids), "patches": patches.shape[0],
                         "vision_rel": rel(out["card"][0], out["host"][0]),
                         "logits_rel": rel(out["card"][1], out["host"][1]),
                         "argmax_card": int(out["card"][1].argmax()),
                         "argmax_host": int(out["host"][1].argmax()),
                         "host_s": out["host"][2]}
        del card, host, out
        torch.cuda.empty_cache()
        check(res["narrow"]["logits_rel"] <= GEN_NARROW_LOGITS_RTOL,
              f"generation: cut judge card vs host {res['narrow']}")

        # (3) the scorers from the files
        args = cli.t3_argument().parse_args([
            "--folder_path", str(scenes), "--clip_path", str(root / "clip"),
            "--longclip_path", str(root / "longclip"),
            "--aesthetic_probe", str(root / "aesthetic.npy"),
            "--musiq_weights", str(root / "musiq.npz")])
        scores, cosines = {}, {}
        make_clip = scorers.make_clip_scorer
        for dev in ("cuda", "cpu"):
            towers = []

            def keeping(vision, text_fn):
                towers.append((vision, text_fn))
                return make_clip(vision, text_fn)
            scorers.make_clip_scorer = keeping
            try:
                fns = cli.build_scorers(args, device=dev)
            finally:
                scorers.make_clip_scorer = make_clip
            t0 = time.perf_counter()
            scores[dev] = {
                "clip": fns["clip"](frames, prompt),
                "longclip": fns["longclip"](frames, prompt),
                "aesthetic": fns["aesthetic"](frames),
                "musiq": fns["musiq"](frames)}
            scores[dev]["seconds"] = time.perf_counter() - t0
            # CLIPScore and LongCLIP clamp each frame's cosine at 0: the
            # cosines before the clamp are what the two sides compare
            cosines[dev] = {k: clip_cosines(vision, text_fn, frames, prompt)
                            for k, (vision, text_fn)
                            in zip(("clip", "longclip"), towers)}
            del fns, towers
        res["scores"] = {
            k: {"card": scores["cuda"][k], "host": scores["cpu"][k],
                "rel": abs(scores["cuda"][k] - scores["cpu"][k])
                / abs(scores["cpu"][k])}
            for k in ("aesthetic", "musiq")}
        for k in ("clip", "longclip"):
            card, host = cosines["cuda"][k], cosines["cpu"][k]
            res["scores"][k] = {
                "card": scores["cuda"][k], "host": scores["cpu"][k],
                "cos_card": card.tolist(), "cos_host": host.tolist(),
                "rel": float(np.abs(card - host).max()
                             / np.abs(host).max())}
        res["scores_s"] = {k: scores[k]["seconds"] for k in scores}
    log(f"generation: card vs host CPU {json.dumps(res)}")
    check(all(v["rel"] <= GEN_SCORE_RTOL for v in res["scores"].values()),
          f"generation: scorers card vs host {res['scores']}")
    return res


def scene_folders(out_dir: Path) -> Path:
    """One text→3DGS request through the CLI's request loop
    `cli/inference_t23d.py::run` (what `main` runs once it has loaded its
    files) on modules drawn from seeds, the denoise cut to
    `T23D_PROFILE_STEPS` steps as phase `denoise`'s profiled request is:
    one {prompt.txt, gs.mp4, ...} folder under `out_dir`."""
    import torch

    from vist3a_tpu_torch.cli import inference_t23d
    from vist3a_tpu_torch.pipelines import t23d

    cfg = dataclasses.replace(t23d.T23DConfig(),
                              num_inference_steps=T23D_PROFILE_STEPS)
    modules = {**build_generator(cfg), "vae": build_vae(),
               "stitched": build_stitched()}
    t0 = time.perf_counter()
    results = inference_t23d.run(modules, fake_tokenizer(cfg.umt5), [PROMPT],
                                 str(out_dir), cfg)
    log(f"generation: one {T23D_PROFILE_STEPS}-step request for its scene "
        f"in {time.perf_counter() - t0:.1f} s: "
        f"{_check_summary(results[0][1], GAUSSIANS)}")
    del modules
    torch.cuda.empty_cache()
    return out_dir


def phase_generation(scenes: str | None = None) -> dict:
    """`cli/gen_eval.py::main` (t3 and dpg) at full width on the scorers'
    released layouts written from seeded modules (`drive_generation`; the
    free disk read first, everything deleted after), over phase `cli`'s two
    request folders (`scenes`) or, when that phase did not run, one
    request's folder (`scene_folders`); then the card against the host
    (`generation_reference`)."""
    import torch

    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="vist3a_generation_"))
    try:
        if scenes is None:
            scenes = scene_folders(tmp / "scenes")
        t0 = time.perf_counter()
        src = build_generation_sources()
        built_s = time.perf_counter() - t0
        params = {k: sum(p.numel() for p in m.parameters())
                  for k, m in src.items() if hasattr(m, "parameters")}
        need = sum(p.numel() * p.element_size() for m in src.values()
                   if hasattr(m, "parameters")
                   for p in m.parameters()) + GEN_EXTRA_BYTES
        log(f"generation: sources drawn on the card in {built_s:.1f} s (the "
            f"judge kept there, the rest moved to the host): "
            f"{json.dumps(params)} parameters; the judge "
            f"{params['judge_vision'] + params['judge_text']}")
        free = shutil.disk_usage(tmp).free
        check(free >= CLI_DISK_FACTOR * need,
              f"generation: {free} B free under {tmp}; the files need about "
              f"{need} B (×{CLI_DISK_FACTOR} asked)")
        res = drive_generation(
            src, tmp, Path(scenes),
            tokenizer=StandInQwenTokenizer(QWEN_SPECIALS, QWEN_WORDS))
        del src
        res["reference"] = generation_reference(Path(scenes),
                                                tmp / "weights")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if scenes is not None:
            shutil.rmtree(scenes, ignore_errors=True)
        torch.cuda.empty_cache()
    res["params"] = params
    t3i, dpgi = res["t3_info"], res["dpg_info"]
    calls = t3i["calls"]["sample_video_frames"]
    log(f"generation: t3 main {t3i['seconds']:.1f} s (read "
        f"{t3i['read_s']:.1f} s, frames {sum(calls):.2f} s over "
        f"{len(calls)} folders), peak {t3i['peak_bytes']} B; seconds per "
        f"scorer per folder " + json.dumps(
            {k: [round(x, 3) for x in v] for k, v in res["scorer_s"].items()})
        + f"; summary {json.dumps(res['t3']['summary'])}")
    load_s = dpgi["calls"]["load_judge"][0]
    log(f"generation: dpg main {dpgi['seconds']:.1f} s (the judge's "
        f"{res['bytes']['judge']} B written in {res['write_s']:.1f} s with "
        f"the other files, read in {dpgi['read_s']:.1f} s, imported and "
        f"placed in {load_s - dpgi['read_s']:.1f} s), peak "
        f"{dpgi['peak_bytes']} B; "
        f"dpg_score {res['dpg']['dpg_score']}, l1 "
        f"{json.dumps(res['dpg']['l1'])}; answers {res['answers']}; "
        f"children zeroed {res['dpg_zeroed']}; judge "
        f"{json.dumps(res['dpg_judge'])}")
    log(f"generation: unified reward {json.dumps(res['unified_reward'])}; "
        f"judge tensors equal to what was written "
        f"{res['judge_tensors_compared']}; peak {res['peak_bytes']} B; "
        f"launches of the repo's kernels on the mains "
        f"{json.dumps(res['launches'])}")
    return res


def _kernel_entries(timed: dict, raster: list | None,
                    launches: dict) -> list:
    """One entry per kernel entry point, each timed at its main-path
    shape.  `launches` counts the entry's main path: for the bf16 forwards
    and the composite the two CLI requests of phase `cli` where it ran,
    else the first of the whole text→3DGS request of phase `denoise`, the
    decode, the stitched-decoder slice and the VDM step that did; for the fp32 forward and the fp32 backward the two
    distillation steps of phase `train`; for the bf16 backward (kernels 4b
    and 5) and the composite backward (kernel 7) the VDM step of phase
    `vdm`; for the q/k prologue (which replaces no TPU kernel) the CLI
    requests of phase `cli`, else the request of phase `denoise`, else the
    VDM step's rollout, and `launches_per_forward` phase `kernels`' 14B and
    1.3B forwards.  `launches_by_path` has each path's; phases `cli14b` (the 14B
    request and its validation views as `cli14b`, the point-head decode as
    `cli14b_point`), `workflows`,
    `evaluation` (the NVS main and the post-optimisation: rows 1 bf16, 2,
    6 and kernel 7) and `generation` (the gen_eval mains, none: the t3
    main's fp32 scorers as `generation_fp32`, the dpg main's bf16 judge
    as `generation_bf16`) add theirs.  The masked flash entry's
    top-level numbers are those of the global shape, which holds 24 of its
    48 launches and ~92 % of its FLOPs, the natural entry's those of the
    1.3B DiT (the 14B heads are in `shapes`), the fp32 entries' those of the
    global attention at S = 13, kernel 4b's those of the global attention
    at S = 13 and kernel 5's those of the re-evaluation (6, 4096, 12, 128),
    and `shapes` carries every measured shape; the composites' are those of
    the first raster view, and `views` carries each view's."""
    added = ("cli14b", "workflows", "evaluation", "generation",
             "distributed")

    def count(counter, paths):
        by_path = {path: c[counter] for path, c in launches.items()
                   if c is not None and path in paths}
        main = next((by_path[p] for p in paths if p in by_path
                     and not p.startswith(added)), None)
        # phases `workflows` and `evaluation` drive the paths of slices 11
        # and 12: their launches add to the main path's
        extra = sum(n for p, n in by_path.items() if p.startswith(added))
        if extra:
            main = (main or 0) + extra
        return main, by_path

    bf16_paths = ("cli", "denoise", "decode", "slice", "vdm",
                  "cli14b", "cli14b_point", "workflows_bf16", "evaluation",
                  "generation_bf16", "distributed_vdm", "distributed_denoise")
    shape_keys = ("case", "shape", "kernel_ms", "plain_ms", "bound_ms",
                  "library_ms", "max_abs_err_o", "o_excess",
                  "max_abs_err_lse")
    entries = []
    for kname, counter, line, source, cases in (
            ("flash_attention_fwd", "unmasked", 187, SM90_SOURCE,
             ("vit", "global_unmasked", "cogvideox")),
            ("flash_attention_fwd_masked", "masked", 756, SM90_SOURCE,
             ("global", "frame")),
            ("flash_attention_fwd_natural", "natural", 78, SM90_SOURCE,
             ("dit_1_3b", "dit_14b"))):
        rs = [timed[c] for c in cases if c in timed]
        if not rs:
            continue
        r = rs[0]
        main, by_path = count(counter, bf16_paths)
        entries.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": f"vist3a_tpu/kernels/flash_attention.py:{line}",
            "launches": main, "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err_o"] for x in rs),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "shapes": [{k: x[k] for k in shape_keys} for x in rs]})
    f32 = [timed[c] for c in F32_TIMED if c in timed]
    if f32:
        r = f32[1] if len(f32) > 1 else f32[0]
        for kname, source, line, counter, pre in (
                ("flash_attention_fwd_f32", F32_SOURCE, 187, "unmasked",
                 "fwd"),
                ("flash_attention_bwd", F32_BWD_SOURCE, 397, "backward",
                 "bwd")):
            main, by_path = count(counter, ("train", "workflows_fp32",
                                            "generation_fp32",
                                            "distributed_ddp"))
            entries.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": f"vist3a_tpu/kernels/flash_attention.py:{line}",
                "launches": main, "launches_by_path": by_path,
                "max_abs_err": max(
                    x["max_abs_err_o" if pre == "fwd"
                      else "max_abs_err_grads"] for x in f32),
                "ms": r[f"{pre}_ms"],
                # the plain version computes the forward and the backward
                # in one call: its time stands beside both entries
                "plain_ms": r["plain_fwd_bwd_ms"],
                "bound_ms": r[f"{pre}_bound_ms"],
                "bound_by": r[f"{pre}_bound_by"],
                "library_ms": r[f"library_{pre}_ms"],
                "library_backend": r["library_backend"],
                "shape": r["shape"],
                "bound_ffma_ms": r[f"{pre}_bound_ffma_ms"],
                "shapes": [{k: x[k] for k in (
                    "case", "shape", f"{pre}_ms", f"{pre}_bound_ms",
                    f"{pre}_bound_ffma_ms", f"{pre}_vs_library",
                    "plain_fwd_bwd_ms", f"library_{pre}_ms", "rel_err_o",
                    "rel_err_dq", "rel_err_dk", "rel_err_dv")}
                    for x in f32]})
    for kname, counter, line, source, cases in (
            ("flash_attention_bwd_bf16", "backward_bf16", 397,
             SM90_BWD_SOURCE, ("bf16_global_s13", "bf16_vit_frame")),
            # `_dq_kernel` (:571) and `_dkv_kernel` (:608)
            ("flash_attention_bwd_natural", "backward_natural", 571,
             SM90_BWD_SOURCE, ("bf16_dit_reeval", "bf16_dit_sft"))):
        rs = [timed[c] for c in cases if c in timed]
        if not rs:
            continue
        r = rs[0]
        main, by_path = count(counter, ("vdm", "workflows_bf16",
                                        "generation_bf16", "distributed_vdm"))
        entries.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": f"vist3a_tpu/kernels/flash_attention.py:{line}",
            "launches": main, "launches_by_path": by_path,
            "max_abs_err": max(x[f"max_abs_err_d{g}"] for x in rs
                               for g in "qkv"),
            "ms": r["bwd_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "shapes": [{k: x[k] for k in (
                "case", "shape", "bwd_ms", "plain_ms", "bound_ms",
                "library_ms", "excess_dq", "excess_dk", "excess_dv")}
                for x in rs]})
    if raster:
        main, by_path = count("composite", bf16_paths)
        r = raster[0]
        entries.append({
            "name": "rasterize_composite_fwd", "route": "cuda",
            "source": RASTER_SOURCE,
            "replaces": "vist3a_tpu/kernels/rasterizer.py:531",
            "launches": main, "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in raster),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "shape": {"image": [IMAGE, IMAGE], "gaussians": r["gaussians"],
                      "pairs": r["pairs"]},
            "views": [{k: x[k] for k in ("view", "pairs", "kernel_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "max_abs_err", "off_share",
                                         "share_of_bound")}
                      for x in raster]})
        main, by_path = count("composite_backward",
                              ("vdm", "workflows_bf16", "evaluation",
                               "generation_bf16"))
        rb = [x["backward"] for x in raster]
        entries.append({
            "name": "rasterize_composite_bwd", "route": "cuda",
            "source": RASTER_BWD_SOURCE,
            "replaces": "vist3a_tpu/kernels/rasterizer.py:568",
            "launches": main, "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rb),
            "ms": rb[0]["kernel_ms"], "plain_ms": rb[0]["plain_ms"],
            "bound_ms": rb[0]["bound_ms"], "bound_by": rb[0]["bound_by"],
            "library_ms": None,
            "shape": {"image": [IMAGE, IMAGE], "gaussians": r["gaussians"],
                      "pairs": rb[0]["pairs"],
                      "pair_budget": rb[0]["pair_budget"]},
            "views": [{k: x[k] for k in ("view", "pairs", "kernel_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "max_abs_err", "off_share",
                                         "share_of_bound")}
                      for x in rb]})
    qk = [timed[c[0]] for c in QK_CASES if c[0] in timed]
    if qk:
        # the inference forwards of the DiT; with grad its plain version runs
        main, by_path = count("qk_prologue", (
            "cli", "denoise", "cli14b", "vdm", "workflows_bf16",
            "distributed_denoise"))
        entries.append({
            "name": "qk_prologue", "route": "cuda", "source": QK_SOURCE,
            "replaces": None,
            "launches": main, "launches_by_path": by_path,
            "launches_per_forward": timed.get("qk_launches"),
            "max_ulps": max(u for x in qk for u in x["max_ulps"]),
            "ms": qk[0]["kernel_ms"], "plain_ms": qk[0]["plain_ms"],
            "bound_ms": qk[0]["bound_ms"], "bound_by": qk[0]["bound_by"],
            "library_ms": None, "shape": qk[0]["shape"],
            "shapes": [{k: x[k] for k in (
                "case", "shape", "heads", "parts", "rope", "kernel_ms",
                "plain_ms", "bound_ms", "share_of_bound", "max_ulps",
                "differ_share")} for x in qk]})
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "vist3a_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    # fp32 matmuls and convolutions stay fp32 on the card (cuDNN would run
    # fp32 convolutions in TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.perf_counter()
    seconds = {}

    def run(phase, fn, *args):
        """fn(*args) if `phase` was asked for (else None), timed."""
        if phase not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        return out

    name = phase_device()
    run("build", phase_build)
    timed = run("kernels", phase_kernels) or {}
    model = build_stitched() if {"raster", "slice", "profile", "decode",
                                 "denoise"} & set(phases) else None
    vae = build_vae() if {"decode", "denoise"} & set(phases) else None
    raster = run("raster", phase_raster, model)
    profile = "profile" in phases
    sliced = run("slice", phase_slice, model, profile)
    run("reference", phase_reference)
    decoded = run("decode", phase_decode, model, vae, profile)
    denoised = run("denoise", phase_denoise, model, vae, profile)
    del model, vae
    served = run("cli", phase_cli, "generation" in phases,
                 "cli14b" in phases)
    served14b = run("cli14b", phase_cli14b, served and served.get("weights"))
    trained = run("train", phase_train)
    tuned = run("vdm", phase_vdm)
    dist_res = run("distributed", phase_distributed)
    workflows = run("workflows", phase_workflows)
    evaluated = run("evaluation", phase_evaluation)
    generated = run("generation", phase_generation,
                    served and served.get("scenes"))
    log(f"seconds by phase {json.dumps(seconds)}; whole script "
        f"{time.perf_counter() - start:.1f} s")

    launches = {"slice": sliced and {**sliced["launches"], "composite": 0,
                                     "natural": 0},
                "decode": decoded and {**decoded["launches"], "natural": 0},
                "denoise": denoised and denoised["launches"],
                "cli": served and served["launches"],
                "cli14b": served14b and served14b["launches"],
                "cli14b_point": served14b and served14b["point"]["launches"],
                "train": trained and trained["launches"],
                "vdm": tuned and tuned["launches"]}
    if workflows:
        # the fp32 kernels ran in the search and the distillation, the bf16
        # ones in the VDM step
        fp32 = [workflows[k]["info"]["launches"]
                for k in ("search", "distillation")]
        launches["workflows_fp32"] = {k: fp32[0][k] + fp32[1][k]
                                      for k in fp32[0]}
        launches["workflows_bf16"] = workflows["vdm"]["info"]["launches"]
    if dist_res:
        # the wrapped steps on the one-rank NCCL mesh (the plain steps they
        # are held against are not counted)
        launches["distributed_ddp"] = dist_res["distillation"]["launches"]
        launches["distributed_vdm"] = dist_res["vdm"]["launches"]
        launches["distributed_denoise"] = dist_res["denoise"]["launches"]
    if evaluated:
        # the NVS main's forwards and renders and the refinement's steps
        launches["evaluation"] = evaluated["launches"]
    if generated:
        # the gen_eval mains: no kernel of the repo on their path
        launches.update(generated["launches"])
    print(json.dumps({"kernels": _kernel_entries(timed, raster, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
