#!/usr/bin/env python3
"""Plant faults in the port's flash-attention and composite-backward
kernels and check that `chip_smoke.py`'s tolerances catch them (needs one
NVIDIA GPU and nvcc).

    python3 tools/torch_flash_mutants.py [--out results.json]

Each mutant is one kernel source with one fault planted by textual
replacement (`MUTANTS`: the source, the edits, the kind of check and the
cases it is judged on):
  * `csrc/flash_attention_fwd.cu` (the mma.sync forward, which serves the
    bf16 head dims other than 64 and 128): five faults on the PV side of
    the kernel, where a fault can leave the LSE untouched, so only the O
    check can see it, judged on the head_dim-40 and 96 cases it serves;
  * `csrc/flash_attention_fwd_sm90.cu` (the wgmma forward of the bf16
    calls at head_dim 64 and 128, masked or not): the last key tile's P·V
    skipped, in both instantiations (judged at head_dim 128) and in the
    D = 64 ones alone (judged at head_dim 64), the O accumulators not
    rescaled on a new max (judged where there is more than one key tile),
    the keys beyond N_k left unmasked (TMA fills them with zeros, whose
    scores are 0, not −∞; judged on the ragged cases), and two faults of
    the mask: the dead keys among each tile's first 16 left live (judged
    on the frame and global attention, whose dead keys sit inside tiles)
    and the bias added on the last tile only (judged on the global
    attention);
  * `csrc/flash_attention_bwd.cu`: δ dropped and the dK/dV kernel's last
    query tile skipped, in its bf16 kernels (judged at the head_dim 48 and
    96 cases they serve);
  * `csrc/flash_attention_fwd_f32_sm90.cu` and
    `csrc/flash_attention_bwd_f32_sm90.cu` (the 3×TF32 kernels of every
    fp32 call), each judged on the fp32 cases: the forward's last key tile
    of P·V skipped; δ dropped and the dK/dV kernel's last query tile
    skipped in the backward; and, in either, the two correction products
    dropped (one TF32 product, ~3 digits) and one of them dropped;
  * `csrc/flash_attention_bwd_sm90.cu` (the wgmma backward at head_dim 64
    and 128): the same two faults, in both instantiations (judged at
    head_dim 128) and in the D = 64 ones alone (judged at head_dim 64);
  * `csrc/rasterize_fwd.cu` and `csrc/rasterize_bwd.cu` (the composites),
    each judged on a random 448² scene (the backward at the reward's pair
    budget with a random cotangent) and on the grazing scene of
    `tests/raster_cases.py` (72×40): in either, the cull mask of
    `csrc/raster_common.cuh` without its margins and with its extents
    scaled by 0.9; the forward compositing its stopping pair; one warp's
    partial left out of the backward's cross-warp sum, the backward's
    reduce-scatter without its last stage (lane offset 1), and the T_final
    cotangent dropped from it (the g_T·T_N term of every dα).
The mutated sources are written to and built in a fresh temporary
directory, one per mutant (the checkout is not touched; a mutated header
sits beside its source, where `#include "..."` looks first, and the
unchanged `csrc/` headers are found through `-I`), one nvcc each, all at
once.  Every library — the
unchanged sources first — is loaded in place of the kernel's own and
driven through the wrappers on the same seeded inputs, judged by
`chip_smoke`'s own comparisons: `compare_case` for the forward (each |ΔO|
within `O_ATOL_STD` of the plain output's std plus `O_RTOL` of itself,
LSE within `LSE_ATOL`; also, for comparison, the fixed O limit of 2e-2
that the script used before), `compare_f32_case` (the `F32_*` limits),
`compare_bf16_bwd_case` (`GRAD_ATOL_STD`, `GRAD_RTOL`, the same bits
twice), `compare_composite` (`RASTER_ATOL`, `RASTER_MAX_OFF_SHARE`) and
`compare_composite_bwd` (`RASTER_BWD_*`).  The script fails
unless the unchanged kernels pass every case and every mutant fails every
case it is judged on.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OLD_O_ATOL = 2e-2
FWD = "flash_attention_fwd.cu"
FWD_SM90 = "flash_attention_fwd_sm90.cu"
BWD = "flash_attention_bwd.cu"
BWD_SM90 = "flash_attention_bwd_sm90.cu"
FWD_F32 = "flash_attention_fwd_f32_sm90.cu"
BWD_F32 = "flash_attention_bwd_f32_sm90.cu"
RASTER_FWD = "rasterize_fwd.cu"
RASTER_BWD = "rasterize_bwd.cu"
RASTER_HEADER = "raster_common.cuh"
# the composites' cases: a random 448² scene and the grazing scene
RASTER_CASES = ("random_448", "grazing")

# forward cases (chip_smoke.Case arguments: name, B, N, H, D, pad keys,
# frame length): head_dim 64 and 128 take the wgmma kernel, 40 and 96 the
# mma.sync kernel (over 18 key tiles of 64; the last holds live keys)
FWD_CASES = (("dit_1_3b", 2, 4096, 12, 128, 0),
             ("dit_14b", 2, 4096, 40, 128, 0),
             ("natural_ragged", 2, 1100, 2, 128, 0),
             ("natural_short", 1, 45, 3, 128, 0),
             ("vit", 13, 1029, 16, 64, 0),
             ("frame", 13, 1040, 16, 64, 11),
             ("global", 1, 13520, 16, 64, 11, 1040),
             ("ragged_d64", 2, 1100, 2, 64, 0),
             ("short_d64", 1, 45, 3, 64, 0),
             ("ragged_d128", 2, 333, 3, 128, 7),
             ("mma_d40", 2, 1100, 2, 40, 0),
             ("mma_d96", 2, 1100, 2, 96, 7))
MMA_FWD_CASES = ("mma_d40", "mma_d96")
SM90_D64_FWD_CASES = ("vit", "frame", "global", "ragged_d64", "short_d64")
# fp32 (name, shape): the training step's ViT/frame shape, a 4096-token
# global-like one, ragged and short
F32_CASES = (("f32_vit_frame", (13, 1029, 16, 64)),
             ("f32_4096", (1, 4096, 4, 64)),
             ("f32_ragged", (2, 1100, 2, 64)),
             ("f32_short", (1, 45, 3, 64)))
F32_NAMES = tuple(n for n, _ in F32_CASES)
# bf16 backward (name, shape): head_dim 48 and 96 take the mma.sync
# kernels, 64 and 128 the wgmma kernels
BF16_CASES = (("bf16_vit_frame", (13, 1029, 16, 64)),
              ("bf16_ragged_d64", (2, 1100, 2, 64)),
              ("bf16_short", (1, 45, 3, 64)),
              ("bf16_ragged_d96", (2, 333, 3, 96)),
              ("bf16_ragged_d48", (2, 333, 3, 48)),
              ("bf16_d48_1100", (2, 1100, 2, 48)),
              ("bf16_4096_d128", (1, 4096, 4, 128)),
              ("bf16_ragged_d128", (2, 333, 3, 128)),
              ("bf16_short_d128", (1, 45, 3, 128)))
MMA_BF16_CASES = ("bf16_ragged_d96", "bf16_ragged_d48", "bf16_d48_1100")
SM90_BF16_CASES = ("bf16_4096_d128", "bf16_ragged_d128", "bf16_short_d128")
SM90_D64_BF16_CASES = ("bf16_vit_frame", "bf16_ragged_d64", "bf16_short")


def _mutant(source, kind, cases, *edits, headers=None):
    """`headers`: {header name: [(text, replacement), ...]} edits of a
    `csrc/` header the source includes."""
    return {"source": source, "kind": kind, "cases": cases,
            "edits": list(edits), "headers": headers or {}}


# the cull mask without its margins, its extents scaled by 0.9
CULL_TOO_TIGHT = {RASTER_HEADER: [
    ("constexpr float kCullDiag = 1e-4f;", "constexpr float kCullDiag = 0.f;"),
    ("constexpr float kCullDet = 1e-5f;", "constexpr float kCullDet = 0.f;"),
    ("constexpr float kCullLevel = 1e-4f;",
     "constexpr float kCullLevel = 0.f;"),
    ("constexpr float kCullExtent = 1e-4f;",
     "constexpr float kCullExtent = -0.1f;"),
    ("constexpr float kCullPad = 1e-2f;", "constexpr float kCullPad = 0.f;")]}


# name → the source, the kind of check, the cases it is judged on, and its
# edits [(text of the unchanged source, its replacement), ...]
MUTANTS = {
    # the last key tile's P·V product is skipped; its keys stay in the sum l
    "pv_skips_last_tile": _mutant(
        FWD, "fwd", MMA_FWD_CASES,
        ("        mma_16816(acc[n], a0, a1, a2, a3, b0, b1);",
         "        if (tile + 1 < n_tiles) "
         "mma_16816(acc[n], a0, a1, a2, a3, b0, b1);")),
    # the first key of every tile is dropped from P·V only
    "pv_drops_a_key_per_tile": _mutant(
        FWD, "fwd", MMA_FWD_CASES,
        ("const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);",
         "const uint32_t a0 = pack_bf16(kk == 0 && t == 0 ? 0.f : "
         "s[2 * kk][0], s[2 * kk][1]);")),
    # the O accumulators are not rescaled when the running max grows
    "acc_not_rescaled": _mutant(
        FWD, "fwd", MMA_FWD_CASES,
        ("      acc[n][0] *= alpha0;\n      acc[n][1] *= alpha0;\n"
         "      acc[n][2] *= alpha1;\n      acc[n][3] *= alpha1;\n", "")),
    # each key's V row lands in the next key's column of the Vᵀ tile
    "v_tile_shifted_one_key": _mutant(
        FWD, "fwd", MMA_FWD_CASES,
        ("vt_s[(col + j) * VS + r] = e[j];",
         "vt_s[(col + j) * VS + (r + 1) % kBlockK] = e[j];")),
    # V's last 8 feature columns are never loaded
    "v_last_chunk_zero": _mutant(
        FWD, "fwd", MMA_FWD_CASES,
        ("if (key0 + r < p.n_k && col < p.d)\n        val = "
         "*reinterpret_cast<const uint4*>(vb",
         "if (key0 + r < p.n_k && col + 8 < p.d)\n        val = "
         "*reinterpret_cast<const uint4*>(vb")),
    # wgmma forward: the last key tile's P·V is skipped (its keys stay in l)
    "sm90_pv_skips_last_tile": _mutant(
        FWD_SM90, "fwd",
        ("dit_1_3b", "dit_14b", "natural_ragged", "natural_short"),
        ("        wgmma_rs(o, pf[kk],",
         "        if (j + 1 < n_tiles) wgmma_rs(o, pf[kk],")),
    # the same in the D = 64 instantiations alone
    "sm90_d64_pv_skips_last_tile": _mutant(
        FWD_SM90, "fwd", SM90_D64_FWD_CASES,
        ("        wgmma_rs(o, pf[kk],",
         "        if (D != 64 || j + 1 < n_tiles) wgmma_rs(o, pf[kk],")),
    # wgmma forward: O not rescaled on a new max (live from the second tile)
    "sm90_acc_not_rescaled": _mutant(
        FWD_SM90, "fwd", ("dit_1_3b", "dit_14b", "natural_ragged"),
        ("        o[i] *= alpha0;\n        o[i + 1] *= alpha0;\n"
         "        o[i + 2] *= alpha1;\n        o[i + 3] *= alpha1;\n", "")),
    # wgmma forward: TMA's zero-filled keys beyond N_k keep their score 0
    "sm90_keys_beyond_n_unmasked": _mutant(
        FWD_SM90, "fwd",
        ("natural_ragged", "natural_short", "ragged_d64", "short_d64"),
        ("            if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= p.n_k)\n"
         "              sacc[i] = -INFINITY;", "            ;")),
    # masked wgmma forward: the bias of each tile's first 16 keys is not
    # added, so the dead keys among them stay live (the frame's 11 dead
    # keys, 1029-1039, are the 6th to 16th of its last tile)
    "sm90_dead_keys_live": _mutant(
        FWD_SM90, "fwd", ("frame", "global"),
        ("          for (int i = 0; i < 64; i += 4) {\n"
         "            const float2 bb =",
         "          for (int i = 8; i < 64; i += 4) {\n"
         "            const float2 bb =")),
    # masked wgmma forward: the bias is added on the last tile only, as if
    # the dead keys lay at the end of the sequence
    "sm90_bias_last_tile_only": _mutant(
        FWD_SM90, "fwd", ("global",),
        ("        if (p.tile_masked[j]) {",
         "        if (p.tile_masked[j] && j + 1 == n_tiles) {")),
    # the fp32 forward drops the last key tile's P·V (and its rescale);
    # its keys stay in the sum l
    "f32_pv_skips_last_tile": _mutant(
        FWD_F32, "f32", F32_NAMES,
        ("      add_tile(o, pv, alpha0, alpha1);",
         "      if (j + 1 < n_tiles) add_tile(o, pv, alpha0, alpha1);")),
    # δ = rowsum(dO∘O) read as 0 in both fp32 kernels: dS = P∘dP
    "delta_dropped": _mutant(
        BWD_F32, "f32", F32_NAMES,
        ("dpt[i] = st[i] * (dpt[i] - dl_t[col]);", "dpt[i] = st[i] * dpt[i];"),
        ("dp[i] = pr * (dp[i] - (hi ? dl1 : dl0));", "dp[i] = pr * dp[i];")),
    # the fp32 dK/dV kernel releases its last query tile unused
    "dkv_skips_last_query_tile": _mutant(
        BWD_F32, "f32", F32_NAMES,
        ("      mbar_wait(&full[s], (it / kStages) & 1);\n",
         "      mbar_wait(&full[s], (it / kStages) & 1);\n"
         "      if (it + 1 == n_qtiles) { mbar_arrive(&empty[s]); continue; }\n"
         )),
    # single-pass TF32 (both correction products dropped), and one of them
    # (a_small·b_big) dropped, in each fp32 kernel
    "f32_fwd_single_tf32": _mutant(
        FWD_F32, "f32", F32_NAMES,
        ("constexpr int kCorrections = 2;", "constexpr int kCorrections = 0;")),
    "f32_fwd_one_correction": _mutant(
        FWD_F32, "f32", F32_NAMES,
        ("constexpr int kCorrections = 2;", "constexpr int kCorrections = 1;")),
    "f32_bwd_single_tf32": _mutant(
        BWD_F32, "f32", F32_NAMES,
        ("constexpr int kCorrections = 2;", "constexpr int kCorrections = 0;")),
    "f32_bwd_one_correction": _mutant(
        BWD_F32, "f32", F32_NAMES,
        ("constexpr int kCorrections = 2;", "constexpr int kCorrections = 1;")),
    # the same two faults in the bf16 mma.sync kernels
    "bf16_delta_dropped": _mutant(
        BWD, "bf16", MMA_BF16_CASES,
        ("dl_s[tid] = live ? delta_b[q0 + tid] : 0.f;", "dl_s[tid] = 0.f;"),
        ("const float dl0 = qrow < p.n_q ? p.delta[bh * p.n_q + qrow] : 0.f;",
         "const float dl0 = 0.f;"),
        ("const float dl1 = qrow + 8 < p.n_q ? p.delta[bh * p.n_q + qrow + 8]"
         " : 0.f;", "const float dl1 = 0.f;")),
    "bf16_dkv_skips_last_query_tile": _mutant(
        BWD, "bf16", MMA_BF16_CASES,
        ("const int n_qtiles = (p.n_q + kTile - 1) / kTile;",
         "const int n_qtiles = (p.n_q + kTile - 1) / kTile - 1;")),
    # and in the wgmma kernels: δ dropped from both
    "sm90_delta_dropped": _mutant(
        BWD_SM90, "bf16", SM90_BF16_CASES,
        ("dpt[i] = st[i] * (dpt[i] - dl_t[col]);", "dpt[i] = st[i] * dpt[i];"),
        ("dp[i] = pr * (dp[i] - (hi ? dl1 : dl0));", "dp[i] = pr * dp[i];")),
    # the wgmma dK/dV kernel releases its last query tile unused
    "sm90_dkv_skips_last_query_tile": _mutant(
        BWD_SM90, "bf16", SM90_BF16_CASES,
        ("      mbar_wait(&full[s], (it / kStages) & 1);\n",
         "      mbar_wait(&full[s], (it / kStages) & 1);\n"
         "      if (it + 1 == n_qtiles) { mbar_arrive(&empty[s]); continue; }\n"
         )),
    # the same two faults in the D = 64 instantiations alone
    "sm90_d64_delta_dropped": _mutant(
        BWD_SM90, "bf16", SM90_D64_BF16_CASES,
        ("dpt[i] = st[i] * (dpt[i] - dl_t[col]);",
         "dpt[i] = st[i] * (dpt[i] - (D == 64 ? 0.f : dl_t[col]));"),
        ("dp[i] = pr * (dp[i] - (hi ? dl1 : dl0));",
         "dp[i] = pr * (dp[i] - (D == 64 ? 0.f : (hi ? dl1 : dl0)));")),
    "sm90_d64_dkv_skips_last_query_tile": _mutant(
        BWD_SM90, "bf16", SM90_D64_BF16_CASES,
        ("      mbar_wait(&full[s], (it / kStages) & 1);\n",
         "      mbar_wait(&full[s], (it / kStages) & 1);\n"
         "      if (D == 64 && it + 1 == n_qtiles) {\n"
         "        mbar_arrive(&empty[s]);\n        continue;\n      }\n")),
    # composite backward: dα without the T_final cotangent
    "composite_bwd_tn_cotangent_dropped": _mutant(
        RASTER_BWD, "raster", RASTER_CASES,
        ("g_tn = g[5] * out[5 * plane + p];", "g_tn = 0.f;")),
    # the composites' cull too tight: pairs culled where they composite
    "composite_fwd_cull_too_tight": _mutant(
        RASTER_FWD, "raster_fwd", RASTER_CASES, headers=CULL_TOO_TIGHT),
    "composite_bwd_cull_too_tight": _mutant(
        RASTER_BWD, "raster", RASTER_CASES, headers=CULL_TOO_TIGHT),
    # the forward composites the pair that stops a pixel
    "composite_fwd_composites_stopping_pair": _mutant(
        RASTER_FWD, "raster_fwd", RASTER_CASES,
        ("      if (t_next < kTEps) {\n        done = true;\n"
         "        continue;\n      }\n",
         "      if (t_next < kTEps) done = true;\n")),
    # the backward's cross-warp sum leaves out the last warp's partials
    "composite_bwd_drops_a_warp": _mutant(
        RASTER_BWD, "raster", RASTER_CASES,
        ("for (int w = 0; w < kWarps; ++w)\n        if (sm.act",
         "for (int w = 0; w < kWarps - 1; ++w)\n        if (sm.act")),
    # the backward's reduce-scatter skips its last stage (lane offset 1)
    "composite_bwd_reduce_scatter_short": _mutant(
        RASTER_BWD, "raster", RASTER_CASES,
        ("  if constexpr (OFF > 0) {", "  if constexpr (OFF > 1) {")),
}


def _mutate(text: str, name: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: the text to replace occurs "
                               f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    return text


def mutated_texts(csrc: Path, name: str) -> dict[str, str]:
    """File name → mutated text of every file mutant `name` changes: its
    source (unchanged where only a header is edited) and its headers."""
    m = MUTANTS[name]
    texts = {m["source"]: _mutate((csrc / m["source"]).read_text(), name,
                                  m["edits"])}
    for header, edits in m["headers"].items():
        texts[header] = _mutate((csrc / header).read_text(), name, edits)
    return texts


def build_mutants(build, workdir: Path) -> dict[str, Path]:
    sources = {}
    for name, m in MUTANTS.items():
        folder = workdir / name
        folder.mkdir()
        for file, text in mutated_texts(build.CSRC_DIR, name).items():
            (folder / file).write_text(text)
        sources[name] = folder / m["source"]

    def nvcc(item):
        name, src = item
        lib = src.with_suffix(".so")
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                               str(build.CSRC_DIR), "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on mutant {name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        return name, lib
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(nvcc, sources.items()))


def run_fwd(cs, fa, torch, names) -> list[dict]:
    rows = []
    for i, args in enumerate(FWD_CASES):
        if args[0] not in names:
            continue
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        res, passed, _ = cs.compare_case(fa, cs.Case(*args), gen)
        rows.append({**res, "passes": passed,
                     "passes_old_limit": res["max_abs_err_o"] <= OLD_O_ATOL
                     and res["max_abs_err_lse"] <= cs.LSE_ATOL})
    return rows


def run_f32(cs, fa, torch, names) -> list[dict]:
    rows = []
    for i, (name, shape) in enumerate(F32_CASES):
        if name in names:
            gen = torch.Generator(device="cuda").manual_seed(200 + i)
            res, passed, _ = cs.compare_f32_case(fa, name, shape, gen)
            rows.append({**res, "passes": passed})
    return rows


def run_bf16(cs, fa, torch, names) -> list[dict]:
    rows = []
    for i, (name, shape) in enumerate(BF16_CASES):
        if name in names:
            gen = torch.Generator(device="cuda").manual_seed(300 + i)
            res, passed, _ = cs.compare_bf16_bwd_case(fa, name, shape, gen)
            rows.append({**res, "passes": passed})
    return rows


def raster_inputs(cs, tr, torch) -> dict:
    """Case → {"args": (gid, bounds, table, ntx, width, height), "out":
    the plain forward's output, "gout": a random cotangent}: one random
    scene at 448² (200,000 splats before an identity camera, opacities up
    to 0.99, the reward's pair budget) and the grazing scene of
    `tests/raster_cases.py` (72×40)."""
    import raster_cases

    gen = torch.Generator(device="cuda").manual_seed(400)
    g, w = 200_000, cs.IMAGE
    means = torch.randn(g, 3, generator=gen, device="cuda") * 0.6
    means[:, 2] += 4.0
    a = torch.randn(g, 3, 3, generator=gen, device="cuda") * 0.03
    covars = a @ a.transpose(1, 2) + 1e-4 * torch.eye(3, device="cuda")
    harm = torch.randn(g, 3, 16, generator=gen, device="cuda") * 0.3
    op = torch.rand(g, generator=gen, device="cuda") * 0.69 + 0.3
    K = torch.tensor([[0.9 * w, 0, w / 2], [0, 0.9 * w, w / 2], [0, 0, 1]],
                     device="cuda")
    table, pairs = tr.view_pairs(means, covars, harm, op,
                                 torch.eye(4, device="cuda"), K, w, w,
                                 13 * w * w)
    grazing = raster_cases.grazing_case(2, exact=False).to("cuda")
    cases = {"random_448": (pairs.gid, pairs.bounds, table, w // tr.TILE, w,
                            w),
             "grazing": tuple(grazing)}
    return {name: {"args": args, "out": tr.composite_ref(*args),
                   "gout": torch.randn(tr.N_OUT, args[5], args[4],
                                       generator=gen, device="cuda")}
            for name, args in cases.items()}


def _judged(name, pairs, compare) -> dict:
    """One composite case: `chip_smoke`'s comparison, whose check of
    finite outputs raises — a mutant's non-finite output fails the case."""
    try:
        res, passed, _ = compare()
    except AssertionError as err:
        return {"case": name, "pairs": pairs, "error": str(err),
                "passes": False}
    return {"case": name, "pairs": pairs, **res, "passes": passed}


def run_raster_fwd(cs, tr, inputs, names) -> list[dict]:
    return [_judged(name, inputs[name]["args"][0].numel(),
                    lambda: cs.compare_composite(tr, *inputs[name]["args"]))
            for name in names]


def run_raster(cs, tr, inputs, names) -> list[dict]:
    rows = []
    for name in names:
        gid, bounds, table, ntx, w, h = inputs[name]["args"]
        out, gout = inputs[name]["out"], inputs[name]["gout"]
        rows.append(_judged(
            name, gid.numel(), lambda: cs.compare_composite_bwd(
                tr, gid, bounds, table, out, gout, ntx, w, h)))
    return rows


def describe(kind: str, r: dict) -> str:
    if "error" in r:
        return r["error"]
    if kind == "fwd":
        return (f"max|ΔO| {r['max_abs_err_o']:.6g} o_excess "
                f"{r['o_excess']:.6g} max|ΔLSE| {r['max_abs_err_lse']:.6g} "
                f"(old 2e-2 limit passes: {r['passes_old_limit']})")
    if kind == "f32":
        return (f"rel|Δ| O {r['rel_err_o']:.3g} dQ {r['rel_err_dq']:.3g} "
                f"dK {r['rel_err_dk']:.3g} dV {r['rel_err_dv']:.3g}")
    if kind == "bf16":
        return (f"excess dQ {r['excess_dq']:.3g} dK {r['excess_dk']:.3g} "
                f"dV {r['excess_dv']:.3g} repeatable "
                f"{r['bitwise_repeatable']}")
    if kind == "raster_fwd":
        return (f"off share {r['off_share']:.3g} max|Δ| by plane "
                f"{r['max_abs_err_by_plane']}")
    return (f"off share {r['off_share']:.3g} max rel by column "
            f"{r['max_rel_err_by_column']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_mutants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import chip_smoke as cs
    from vist3a_tpu_torch.kernels import build
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import rasterizer as tr

    runners = {"fwd": lambda names: run_fwd(cs, fa, torch, names),
               "f32": lambda names: run_f32(cs, fa, torch, names),
               "bf16": lambda names: run_bf16(cs, fa, torch, names),
               "raster_fwd": lambda names: run_raster_fwd(cs, tr, raster,
                                                          names),
               "raster": lambda names: run_raster(cs, tr, raster, names)}
    all_cases = {"fwd": [c[0] for c in FWD_CASES],
                 "f32": [n for n, _ in F32_CASES],
                 "bf16": [n for n, _ in BF16_CASES],
                 "raster_fwd": list(RASTER_CASES),
                 "raster": list(RASTER_CASES)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="flash_mutants_") as tmp:
        t0 = time.perf_counter()
        for load in (fa._lib, fa._bwd_lib, fa._sm90_lib, fa._sm90_bwd_lib,
                     fa._f32_lib, fa._f32_bwd_lib,
                     tr._lib, tr._bwd_lib):         # the unchanged kernels
            load()
        raster = raster_inputs(cs, tr, torch)
        built = build_mutants(build, Path(tmp))
        print(f"built {len(built)} mutants in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        own = dict(build._loaded)
        try:
            results["unchanged"] = {
                kind: run(all_cases[kind]) for kind, run in runners.items()}
            for name, path in built.items():
                m = MUTANTS[name]
                build._loaded[m["source"]] = ctypes.CDLL(str(path))
                try:
                    results[name] = {m["kind"]: runners[m["kind"]](
                        m["cases"])}
                finally:
                    build._loaded[m["source"]] = own[m["source"]]
        finally:
            build._loaded.update(own)
    for name, by_kind in results.items():
        for kind, rows in by_kind.items():
            for r in rows:
                print(f"{name:36s} {r['case']:17s} {describe(kind, r)} "
                      f"passes {r['passes']}", flush=True)
    bad = [f"{kind}/{r['case']}"
           for kind, rows in results["unchanged"].items() for r in rows
           if not r["passes"]]
    missed = [f"{name}/{r['case']}" for name, by_kind in results.items()
              if name != "unchanged" for rows in by_kind.values()
              for r in rows if r["passes"]]
    summary = {"device": smi, "o_atol_std": cs.O_ATOL_STD,
               "o_rtol": cs.O_RTOL, "old_o_atol": OLD_O_ATOL,
               "f32_limits": {"o_rtol": cs.F32_O_RTOL,
                              "grad_rtol": cs.F32_GRAD_RTOL,
                              "lse_atol": cs.F32_LSE_ATOL},
               "grad_limits": {"atol_std": cs.GRAD_ATOL_STD,
                               "rtol": cs.GRAD_RTOL},
               "raster_limits": {"atol": cs.RASTER_ATOL,
                                 "max_off_share": cs.RASTER_MAX_OFF_SHARE},
               "raster_bwd_limits": {"rtol": cs.RASTER_BWD_RTOL,
                                     "max_off_share":
                                         cs.RASTER_BWD_MAX_OFF_SHARE,
                                     "max_rel": cs.RASTER_BWD_MAX_REL},
               "mutants": {n: {k: m[k] for k in ("source", "kind", "cases")}
                           | {"headers": sorted(m["headers"])}
                           for n, m in MUTANTS.items()},
               "results": results}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({"unchanged_fails": bad,
                      "mutant_cases_passed": missed}))
    return 1 if bad or missed else 0


if __name__ == "__main__":
    sys.exit(main())
