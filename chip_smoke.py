#!/usr/bin/env python3
"""Drive the PyTorch port (`vist3a_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels,raster
    python3 chip_smoke.py --phases device,build,kernels,train
    python3 chip_smoke.py --phases device,build,kernels,raster,vdm
    python3 chip_smoke.py --phases device,build,cli
    python3 chip_smoke.py --phases device,build,workflows
    python3 chip_smoke.py --phases device,build,evaluation

Phases, each of which passes or raises (any failure exits non-zero):
  1. device  — the card's name and power limit; fails without CUDA.
  2. build   — builds `vist3a_tpu_torch/csrc/flash_attention_fwd.cu`,
               `csrc/flash_attention_bwd.cu`, the wgmma + TMA kernels
               `csrc/flash_attention_fwd_sm90.cu` and
               `csrc/flash_attention_bwd_sm90.cu`, their fp32 3×TF32
               counterparts `csrc/flash_attention_fwd_f32_sm90.cu` and
               `csrc/flash_attention_bwd_f32_sm90.cu`,
               `csrc/rasterize_fwd.cu` and `csrc/rasterize_bwd.cu` (which
               share `csrc/raster_common.cuh`) for
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
               yardstick) and the bound.
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
               launch each, gs.mp4 and depth.mp4 written, the PLY read
               back).  Two requests.
  9. denoise — the whole of text→3DGS at full width through `text_to_3dgs`:
               UMT5-XXL and the Wan 2.1 1.3B DiT in bf16 (random weights
               drawn on the card from a seed), a seeded fake tokenizer (226
               ids), 50 UniPC steps with CFG batched to B = 2 (30 natural
               flash launches a step, 1500 a request), then the decode and
               export of phase 8 (8 + 48 flash and 133 composite launches).
               Checks the latents (1, 16, 4, 64, 64), the files and the
               launch counts; prints the ms per denoise step, peak memory,
               a profile of 2 denoise steps and, with `profile`, each
               profiler range's host and device time in a request whose
               denoise is cut to `T23D_PROFILE_STEPS` steps.
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
  12. vdm    — reward-aligned VDM fine-tuning at full width: two steps of
               `cli.train_vdm.run` (`VDMTrainConfig()`: LoRA r8 α16 on the
               Wan 2.1 1.3B DiT's attention, bf16; UMT5-XXL for the prompts
               with the stand-in tokenizer of phase `denoise`; the Wan VAE
               in fp32 weights with bf16 activations; the stitched decoder
               bf16; both CLIP-H vision towers, fp32; all drawn on the card
               from seeds) over a synthetic clip (1, 3, 13, 512, 512) and
               random L2-normalised scorer text features.  Step 0 takes the
               50-step rollout (every 10th step), step 1 its drawn and
               bucketed length.  Checks finite losses, grad_norm > 0, no
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
               The run saves `checkpoint-2` (`save_freq`), reloaded into
               a fresh state and held against the live one as in phase 11.
               Cut: B = 1, two steps, random weights and data.
  13. workflows — the three workflows from their command lines at full
               width on files on disk (`drive_workflows`): phase `cli`'s
               source modules plus both scorers' towers (PickScore: HF
               CLIP-H/14 at 224²; DFN5B: open_clip H/14 at 378²; each with
               a CLIP-H text tower; fp32) written in the reference layout
               (`pickscore/` with `logit_scale` and a synthetic `vocab.json`
               + `merges.txt`, `dfn5b/`; ~28 GB, the free disk read first),
               a DL3DV tree (2 scenes × 21 structured frames at 960×540,
               PNG, one scene captioned), a one-scene ScanNet tree and a
               prompt list; then `cli/find_layer.py::main` on 2 DL3DV
               samples (24 MSEs, 24 artifacts, the printed argmin, a
               second main from the cache, the last tap against the
               trunk's own blocks, 24 fp32 flash launches a sample),
               `cli/train_stitching.py::main` over DL3DV + ScanNet from the
               search's `enc_blocks_16` artifact (converted to the {weight,
               bias} `.pth` the main reads; LoRA r64 α32, B = 1, one epoch
               of 3 steps at the seed whose views are 13, 9, 9: finite
               losses, the teacher unchanged, the epoch's checkpoint, the
               JSONL metric stream's 16 terms, phase `train`'s launches a
               step) and `cli/train_vdm.py::main --enable_rl` for one step
               (the 50-step rollout of every 10th step: finite losses, the
               per-prompt text features of the imported towers finite, unit
               norm and the source towers', the frozen modules as written,
               `history.jsonl`, `images/step_000000.png`, `checkpoint-1`,
               `vdm_launches(50)`).  Logs each main's read, load, step and
               extraction seconds, the host fit's seconds, the feature
               cache's bytes and the peak memory.  Cut: random weights,
               synthetic scenes and tokenizer files, a few steps.
  14. evaluation — RE10K novel-view synthesis from its command line and
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
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

PHASES = ("device", "build", "kernels", "raster", "slice", "profile",
          "reference", "decode", "denoise", "cli", "train", "vdm",
          "workflows", "evaluation")
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
VDM_STEPS = 2

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
# a whole text→3DGS request: the prompt embedding and the denoise, then the
# decode's stages
T23D_STAGES = ("t23d.embed", "t23d.denoise", *DECODE_STAGES)
# the denoise steps of phase `denoise`'s profiled request
T23D_PROFILE_STEPS = 5
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
# phase `workflows`: the three command lines on files on disk.  The DL3DV
# tree: 2 scenes of 21 frames at DL3DV's `images_4` size, one of them
# captioned over frames 0-14; a one-scene ScanNet tree; two prompts
WORKFLOW_FRAMES = 21
WORKFLOW_HW = (540, 960)
WORKFLOW_SCANNET_HW = (480, 640)
WORKFLOW_CAPTION_FRAMES = 15
WORKFLOW_PROMPTS = (PROMPT, "a wooden boat on a calm lake")
# the distillation main's three steps (2 DL3DV + 1 ScanNet clip, B = 1):
# the drawn view counts the seed is chosen for
WORKFLOW_STITCH_VIEWS = (13, 9, 9)
# the search's samples and the deployed chop the distillation starts from
WORKFLOW_SEARCH_SAMPLES = 2
WORKFLOW_CHOP = 16
# PickScore's logit scale (the file holds its log; the reward takes exp)
PICK_LOGIT_SCALE = 100.0
# the extra disk the phase's data, features and checkpoints take
WORKFLOW_EXTRA_BYTES = 4 << 30
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
    from vist3a_tpu_torch.kernels import rasterizer as tr

    sources = (fa.SOURCE, fa.BWD_SOURCE, fa.SM90_SOURCE, fa.SM90_BWD_SOURCE,
               fa.F32_SOURCE, fa.F32_BWD_SOURCE, tr.SOURCE, tr.BWD_SOURCE)
    t0 = time.perf_counter()
    build.build_all(list(sources))
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
    return timed


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


def narrow_config():
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
        gs=GSHeadConfig(dim_in=2 * d, features=16,
                        out_channels=(8, 16, 16, 16), output_dim=84,
                        head2_features=16, pos_embed=False))
    return ca.StitchedConfig(encoder=ecfg, stitch_layer_index=2,
                             conv_spec=f"conv3d_k5x3x3_o{d}_s1x2x2_p2x1x1")


def phase_reference() -> dict:
    """Narrow widths at the full spatial shape (5 frames of 448², P = 1029):
    the card runs the kernel (ViT N = 1029, frame 1040, global 5200), the
    host CPU the plain attention, on the same bf16 weights and inputs."""
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    cfg = narrow_config()
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
    log(f"reference: card vs host CPU, max |Δ| / max |ref|: {errs}")
    # Both sides run a bf16 trunk but round at different places (kernel
    # vs plain softmax, cuBLAS vs CPU matmuls); 2^-5 of the output's range
    # separates that rounding from a wrong layout or mask.
    bad = {k: v for k, v in errs.items() if not v <= 2 ** -5}
    check(not bad, f"card and host CPU disagree: {bad}")
    return {**errs, **reference_dit()}


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


def phase_decode(model, vae, profile: bool) -> dict:
    import torch

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

    tmp = tempfile.mkdtemp(prefix="vist3a_decode_")
    latencies, peaks = [], []
    counts = {"unmasked": 0, "masked": 0, "composite": 0}
    try:
        for i in range(DECODE_REQUESTS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            tr.reset_launch_counts()
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
            log(f"decode: request {i}: {latencies[-1]:.1f} ms, launches "
                f"{grew}, video {tuple(video.shape)} in "
                f"[{video.min().item():.4f}, {video.max().item():.4f}], "
                f"{summary}, peak memory {peaks[-1]} B")
            del out, video, arts
            shutil.rmtree(os.path.join(tmp, f"scene{i}"), ignore_errors=True)
        log(f"decode: latency ms {latencies}; peak memory allocated {peaks}; "
            f"launches {counts}")
        if profile:
            profile_call("decode", lambda: request(os.path.join(tmp, "prof")),
                         DECODE_STAGES, RENDER_STAGES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"latency_ms": latencies, "peak_bytes": peaks, "launches": counts}


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

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import rasterizer as tr
    from vist3a_tpu_torch.pipelines import t23d

    cfg = t23d.T23DConfig()
    modules = {**build_generator(cfg), "vae": vae, "stitched": model}
    tokenize = fake_tokenizer(cfg.umt5)
    want = {**LAUNCHES_PER_REQUEST, "composite": ORBIT_VIEWS,
            "natural": cfg.dit.num_layers * cfg.num_inference_steps}

    def request(save_path):
        return t23d.text_to_3dgs(modules, tokenize, PROMPT, save_path, cfg,
                                 orbit_t=ORBIT_T)

    tmp = tempfile.mkdtemp(prefix="vist3a_t23d_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        tr.reset_launch_counts()
        t0 = time.perf_counter()
        res = request(os.path.join(tmp, "scene"))
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
        counts = {"unmasked": fa.launches_unmasked,
                  "masked": fa.launches_masked, "composite": tr.launches,
                  "natural": fa.launches_natural}
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
            # every stage of a request, the denoise cut to a few steps:
            # the profile's event walk takes host time per launch, and a
            # 50-step request launches ~221,000 kernels
            short = dataclasses.replace(
                cfg, num_inference_steps=T23D_PROFILE_STEPS)
            profile_call(f"t23d_{T23D_PROFILE_STEPS}_steps",
                         lambda: t23d.text_to_3dgs(
                             modules, tokenize, PROMPT,
                             os.path.join(tmp, "prof"), short,
                             orbit_t=ORBIT_T),
                         T23D_STAGES, RENDER_STAGES)
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


def peft_adapter(dit, gen, r: int) -> tuple[dict, dict]:
    """A PEFT adapter of rank r on q/k/v/o of both attention blocks of every
    DiT block, lora_B nonzero: ({"base_model.model.blocks.{i}.attn1.to_q.
    lora_A.weight": (r, in), "….lora_B.weight": (out, r), ...}, the same
    factors keyed by the port's weight names {name: (A, B)})."""
    import torch

    adapter, factors = {}, {}
    d = dit.cfg.dim
    for i in range(dit.cfg.num_layers):
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
    if "dit" in src:
        files["umt5_xxl"] = manifests._fab_umt5(src["umt5"])
        files["wan_dit"] = manifests._fab_wan_dit(src["dit"])
    if "pick_vision" in src:
        files["pickscore"] = manifests._fab_pickscore(
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
    if "dit" in src:
        adapter, dit_factors = peft_adapter(src["dit"], gen,
                                           CLI_DIT_LORA_RANK)
        for sub in ("wan_dit", "umt5", "wan_lora"):
            (root / sub).mkdir(parents=True)
        written["wan_dit"] = write_safetensors(
            root / "wan_dit" / "diffusion_pytorch_model.safetensors",
            files["wan_dit"])
        written["umt5"] = write_sharded(root / "umt5", files["umt5_xxl"],
                                        CLI_UMT5_SHARDS)
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


def expected_dit(src_dit, factors: dict, scaling: float) -> dict:
    """The DiT's parameters after the PEFT merge, on the host: w, or at a
    site bf16(w + (B@A)·α/r) computed in fp32."""
    out = {k: v.detach().cpu() for k, v in src_dit.state_dict().items()}
    for name, (a, b) in factors.items():
        w = out[name]
        out[name] = (w.float() + (b.float() @ a.float()) * scaling).to(w.dtype)
    return out


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
    n_dit = same_values("DiT", modules["dit"].state_dict(), expected_dit(
        src["dit"], written["dit_factors"],
        CLI_DIT_LORA_ALPHA / CLI_DIT_LORA_RANK))
    n_umt5 = same_values("UMT5", modules["umt5"].state_dict(), {
        k: v.to(torch.bfloat16) for k, v in src["umt5"].state_dict().items()})
    dt = next(modules["vae"].parameters()).dtype
    n_vae = same_values("VAE decoder", modules["vae"].state_dict(), {
        k: v.to(dt) for k, v in src["vae_decoder"].state_dict().items()})
    return {"write_s": write_s, "read_s": read_s,
            "import_s": load_s - read_s, "main_s": main_s,
            "request_s": request_s, "peak_bytes": peak,
            "launches": {k: counts[k] for k in
                         ("unmasked", "masked", "natural", "composite")},
            "bytes": written["bytes"],
            "compared": {"stitched": n_stitched, "dit": n_dit,
                         "umt5": n_umt5, "vae_decoder": n_vae},
            "merged_sites": {"stitched": len(written["factors"]),
                             "dit": len(written["dit_factors"])},
            "results": results}


def build_cli_sources(generator: bool = True) -> dict:
    """The modules whose reference-format files phase `cli` writes, drawn on
    the card from a seed and then moved to the host, so the card is free
    for the CLI's own: the whole AnySplat encoder (fp32, with the camera
    trick of `build_stitched`), the Wan 2.1 VAE (fp32), and with
    `generator` UMT5-XXL and the Wan 2.1 1.3B DiT (bf16)."""
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


def phase_cli() -> dict:
    """`cli/inference_t23d.py::main` on full-width reference-format files:
    two prompts through the whole text→3DGS request, the files written from
    seeded modules (`drive_cli`), every check there, the times, the peak
    memory and the launches."""
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
                       "natural": 30 * 50}
        res = drive_cli(src, ca.StitchedConfig(), CLI_LORA_SPEC, tmp,
                        tokenize=fake_tokenizer(umt5.UMT5_XXL),
                        want_launches={k: len(CLI_PROMPTS) * v
                                       for k, v in per_request.items()})
        for prompt, r in res.pop("results"):
            log(f"cli: '{prompt}': {_check_summary(r, GAUSSIANS)}")
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
        f"{res['merged_sites']})")
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
    backward (kernel 7)."""
    return {"natural": n_layers * (num_steps + 4), "unmasked": 2 * 56,
            "masked": 0, "backward": 0, "backward_bf16": 56,
            "backward_natural": 2 * n_layers, "composite": 2 * 13,
            "composite_backward": 13}


def _vdm_counts() -> dict:
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import rasterizer as tr

    return {"natural": fa.launches_natural,
            "unmasked": fa.launches_unmasked, "masked": fa.launches_masked,
            "backward": fa.launches_backward,
            "backward_bf16": fa.launches_backward_bf16,
            "backward_natural": fa.launches_backward_natural,
            "composite": tr.launches,
            "composite_backward": tr.launches_backward}


def _reset_counts() -> None:
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import rasterizer as tr

    fa.reset_launch_counts()
    tr.reset_launch_counts()


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
    # EMA: e1 = d0·e0 + (1 − d0)·p1, e2 = d1·e1 + (1 − d1)·p2
    d0, d1 = ema_mod.current_decay(0), ema_mod.current_decay(1)
    p1, p2 = marks[0][4], marks[1][4]
    ema_err = max(((state.ema[k] - (d1 * (d0 * ema0[k] + (1 - d0) * p1[k])
                                    + (1 - d1) * p2[k])).abs().max()
                   / p2[k].abs().max().clamp_min(1e-30)).item()
                  for k in state.ema)
    check(ema_err <= 1e-6, f"EMA off its warm-up formula by {ema_err}")
    sums_after = _checksums(frozen)
    changed = [k for k in frozen if sums_after[k] != sums_before[k]]
    check(not changed, f"frozen weights changed: {changed}")
    log(f"vdm: LoRA B factors moved (smallest max |B| {min(b_max):.3g}); "
        f"EMA at its warm-up formula (d = {d0:.4f}, {d1:.4f}; rel err "
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
    machine has no Pillow): a DL3DV tree `dl3dv/1K/scene_{a,b}/images_4/
    frame_XXXXX.png`, its caption JSON (scene_a captioned over frames
    [0, caption_frames)), a one-scene ScanNet tree `scannet/scene0000_00/
    frames/color/<i>.png` and a prompt list.  Returns their paths."""
    import cv2

    paths = {"dl3dv": folder / "dl3dv", "scannet": folder / "scannet",
             "captions": folder / "captions.json",
             "prompts": folder / "prompts.txt"}
    dirs = [(paths["dl3dv"] / "1K" / f"scene_{c}" / "images_4", hw,
             "frame_{:05d}.png", k) for k, c in enumerate("ab")]
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
                  phase: str = "workflows") -> tuple:
    """fn(args, device=device) with the launch counts reset before it, the
    peak device memory from its start, the seconds spent reading files
    (`io/load_weights.py`) and in each of `timed` ((module, names) pairs).
    Returns (fn's result, {"seconds", "read_s", "calls": {name: [s]},
    "peak_bytes", "launches"})."""
    import torch

    from vist3a_tpu_torch.io import load_weights

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    reads, calls = [], []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_calls(load_weights, (
            "load_torch_state_dict", "load_sharded_safetensors"), reads,
            sync))
        for module, names in timed:
            stack.enter_context(timed_calls(module, names, calls, sync))
        out = fn(args, device=device)
    sync()
    info = {"seconds": time.perf_counter() - t0,
            "read_s": sum(x for _, _, x in reads),
            "calls": {n: [x for m, _, x in calls if m == n]
                      for _, names in timed for n in names},
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda
            else None, "launches": _vdm_counts()}
    log(f"{phase}: {label}: {info['seconds']:.1f} s, read "
        f"{info['read_s']:.1f} s, peak memory allocated "
        f"{info['peak_bytes']} B, launches {info['launches']}, calls "
        + json.dumps({n: [round(x, 2) for x in v]
                      for n, v in info["calls"].items()}))
    return out, info


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
                       want_per_step: dict | None) -> dict:
    """`cli/train_stitching.py::main` from the search's artifact at the
    chop (converted to the {weight, bias} `.pth` the main reads), its
    checks; returns the times, the losses and the launches."""
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
                                    "load_wan_vae"))))
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
              want_launches: bool, grid_tiles: tuple) -> dict:
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
                   (cli, ("build_reward_fns",))))
    run_args, run_kw, _ = store.pop("run")
    _, text_fn = store.pop("build_reward_fns")[2]
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
    n_frozen = {
        "dit": same_values("vdm main: DiT", dit.state_dict(),
                           src["dit"].state_dict()),
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
    del run_args, run_kw, dit, vae_enc, vae_dec, stitched, pick, pe, text_fn
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
                    grid_tiles: tuple = (2, 7)) -> dict:
    """The three workflows' mains on one weights root and one scene tree
    under `tmp`: the reference-format files of the source modules `src`
    (on the host, the scorers' towers included), the scenes, then the
    search, the distillation from its artifact at the chop, and one VDM
    step, each with its checks.  `*_flags` are added to each command line
    (the CPU test's sizes); `want_launches` checks each main's kernel
    launches (on the card)."""
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
                                          "composite_backward")}}
        if want_launches else None)
    distill = drive_distillation(src, root, data, tmp / "search",
                                 tmp / "stitching", scfg, stitch_flags,
                                 device=device, want_per_step=per_step)
    tuned = drive_vdm(src, root, written, data, tmp / "vdm", scfg, vdm_flags,
                      tokenize=tokenize, device=device,
                      want_launches=want_launches, grid_tiles=grid_tiles)
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
                              want_launches=True)
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


def _kernel_entries(timed: dict, raster: list | None,
                    launches: dict) -> list:
    """One entry per kernel entry point, each timed at its main-path
    shape.  `launches` counts the entry's main path: for the bf16 forwards
    and the composite the two CLI requests of phase `cli` where it ran,
    else the first of the whole text→3DGS request of phase `denoise`, the
    decode, the stitched-decoder slice and the VDM steps that did; for the fp32 forward and the fp32 backward the two
    distillation steps of phase `train`; for the bf16 backward (kernels 4b
    and 5) and the composite backward (kernel 7) the two VDM steps of phase
    `vdm`.  `launches_by_path` has each path's; phases `workflows` and
    `evaluation` (the NVS main and the post-optimisation: rows 1 bf16, 2,
    6 and kernel 7) add theirs.  The masked flash entry's
    top-level numbers are those of the global shape, which holds 24 of its
    48 launches and ~92 % of its FLOPs, the natural entry's those of the
    1.3B DiT (the 14B heads are in `shapes`), the fp32 entries' those of the
    global attention at S = 13, kernel 4b's those of the global attention
    at S = 13 and kernel 5's those of the re-evaluation (6, 4096, 12, 128),
    and `shapes` carries every measured shape; the composites' are those of
    the first raster view, and `views` carries each view's."""
    added = ("workflows", "evaluation")

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
                  "workflows_bf16", "evaluation")
    shape_keys = ("case", "shape", "kernel_ms", "plain_ms", "bound_ms",
                  "library_ms", "max_abs_err_o", "o_excess",
                  "max_abs_err_lse")
    entries = []
    for kname, counter, line, source, cases in (
            ("flash_attention_fwd", "unmasked", 187, SM90_SOURCE,
             ("vit", "global_unmasked")),
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
            main, by_path = count(counter, ("train", "workflows_fp32"))
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
        main, by_path = count(counter, ("vdm", "workflows_bf16"))
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
                              ("vdm", "workflows_bf16", "evaluation"))
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
    served = run("cli", phase_cli)
    trained = run("train", phase_train)
    tuned = run("vdm", phase_vdm)
    workflows = run("workflows", phase_workflows)
    evaluated = run("evaluation", phase_evaluation)
    log(f"seconds by phase {json.dumps(seconds)}; whole script "
        f"{time.perf_counter() - start:.1f} s")

    launches = {"slice": sliced and {**sliced["launches"], "composite": 0,
                                     "natural": 0},
                "decode": decoded and {**decoded["launches"], "natural": 0},
                "denoise": denoised and denoised["launches"],
                "cli": served and served["launches"],
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
    if evaluated:
        # the NVS main's forwards and renders and the refinement's steps
        launches["evaluation"] = evaluated["launches"]
    print(json.dumps({"kernels": _kernel_entries(timed, raster, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
