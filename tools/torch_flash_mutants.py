#!/usr/bin/env python3
"""Plant faults in the port's flash-attention and composite-backward
kernels and check that `chip_smoke.py`'s tolerances catch them (needs one
NVIDIA GPU and nvcc).

    python3 tools/torch_flash_mutants.py [--out results.json]

Each forward mutant is `csrc/flash_attention_fwd.cu` with one textual
change on the PV side of the kernel, where a fault can leave the LSE
untouched, so only the O check can see it; each backward mutant is
`csrc/flash_attention_bwd.cu` with δ dropped or the dK/dV kernel's last
query tile skipped, in its fp32 or its bf16 kernels; the composite
mutant is `csrc/rasterize_bwd.cu` with the T_final cotangent dropped (the
g_T·T_N term of every dα).  The mutated sources are written to and built in a
fresh temporary directory (the checkout is not touched), one nvcc each, all
at once.  Every library — the unchanged sources first — is loaded in place
of the kernel's own and driven through the wrappers on the same seeded
inputs: the forward mutants at the bf16 cases of `chip_smoke.py`, judged by
`chip_smoke.compare_case` (each |ΔO| within `O_ATOL_STD` of the plain
output's std plus `O_RTOL` of itself, LSE within `LSE_ATOL`) and, for
comparison, by the fixed O limit of 2e-2 that the script used before; the
backward mutants at fp32 cases, judged by `chip_smoke.compare_f32_case`
(O, LSE and the three gradients against the `F32_*` limits); the bf16
backward mutants at bf16 cases (head_dim 64 and 128), judged by
`chip_smoke.compare_bf16_bwd_case` (`GRAD_ATOL_STD`, `GRAD_RTOL`); the
composite mutant on a random 448² scene at the reward's pair budget with a
random cotangent, judged by `chip_smoke.compare_composite_bwd`
(`RASTER_BWD_*`).  The script fails unless the unchanged kernels pass
every case, every forward mutant fails the scaled limit on the natural
(head_dim 128) cases and every backward mutant fails every case of its
kind.
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
# backward mutants: name → [(text of the unchanged source, its
# replacement), ...]
BWD_MUTANTS = {
    # δ = rowsum(dO∘O) read as 0 in both kernels: dS = P∘dP
    "delta_dropped": [
        ("delta_s[tid] = live ? delta_b[q0 + tid] : 0.f;",
         "delta_s[tid] = 0.f;"),
        ("delta[r] = row < p.n_q ? p.delta[bh * p.n_q + row] : 0.f;",
         "delta[r] = 0.f;")],
    # the dK/dV kernel never visits its last query tile
    "dkv_skips_last_query_tile": [
        ("const int n_tiles = (p.n_q + kTile - 1) / kTile;",
         "const int n_tiles = (p.n_q + kTile - 1) / kTile - 1;")],
}
# bf16 backward mutants (the same two faults in the bf16 kernels)
BF16_BWD_MUTANTS = {
    "bf16_delta_dropped": [
        ("dl_s[tid] = live ? delta_b[q0 + tid] : 0.f;", "dl_s[tid] = 0.f;"),
        ("const float dl0 = qrow < p.n_q ? p.delta[bh * p.n_q + qrow] : 0.f;",
         "const float dl0 = 0.f;"),
        ("const float dl1 = qrow + 8 < p.n_q ? p.delta[bh * p.n_q + qrow + 8]"
         " : 0.f;", "const float dl1 = 0.f;")],
    "bf16_dkv_skips_last_query_tile": [
        ("const int n_qtiles = (p.n_q + kTile - 1) / kTile;",
         "const int n_qtiles = (p.n_q + kTile - 1) / kTile - 1;")],
}
# composite backward mutant: dα without the T_final cotangent
RASTER_MUTANTS = {
    "composite_bwd_tn_cotangent_dropped": [
        ("g_tn = g[5] * out[5 * plane + p];", "g_tn = 0.f;")],
}
# forward mutants: name → (text of the unchanged source, its replacement)
MUTANTS = {
    # the last key tile's P·V product is skipped; its keys stay in the sum l
    "pv_skips_last_tile": (
        "        mma_16816(acc[n], a0, a1, a2, a3, b0, b1);",
        "        if (tile + 1 < n_tiles) "
        "mma_16816(acc[n], a0, a1, a2, a3, b0, b1);"),
    # the first key of every tile is dropped from P·V only
    "pv_drops_a_key_per_tile": (
        "const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);",
        "const uint32_t a0 = pack_bf16(kk == 0 && t == 0 ? 0.f : s[2 * kk][0],"
        " s[2 * kk][1]);"),
    # the O accumulators are not rescaled when the running max grows
    "acc_not_rescaled": (
        "      acc[n][0] *= alpha0;\n      acc[n][1] *= alpha0;\n"
        "      acc[n][2] *= alpha1;\n      acc[n][3] *= alpha1;\n", ""),
    # each key's V row lands in the next key's column of the Vᵀ tile
    "v_tile_shifted_one_key": (
        "vt_s[(col + j) * VS + r] = e[j];",
        "vt_s[(col + j) * VS + (r + 1) % kBlockK] = e[j];"),
    # V's last 8 feature columns are never loaded
    "v_last_chunk_zero": (
        "if (key0 + r < p.n_k && col < p.d)\n        val = "
        "*reinterpret_cast<const uint4*>(vb",
        "if (key0 + r < p.n_k && col + 8 < p.d)\n        val = "
        "*reinterpret_cast<const uint4*>(vb"),
}


def cases(cs):
    """chip_smoke's cases, natural (D = 128, unmasked) ones first."""
    return [cs.Case("dit_1_3b", 2, 4096, 12, 128, 0),
            cs.Case("dit_14b", 2, 4096, 40, 128, 0),
            cs.Case("natural_ragged", 2, 1100, 2, 128, 0),
            cs.Case("vit", 13, 1029, 16, 64, 0),
            cs.Case("frame", 13, 1040, 16, 64, 11),
            cs.Case("global", 1, 13520, 16, 64, 11, frame_len=1040),
            cs.Case("ragged_d128", 2, 333, 3, 128, 7)]


def f32_cases():
    """fp32 (name, shape) cases for the backward mutants: the training
    step's ViT/frame shape, a 4096-token global-like one, ragged and
    short."""
    return [("f32_vit_frame", (13, 1029, 16, 64)),
            ("f32_4096", (1, 4096, 4, 64)),
            ("f32_ragged", (2, 1100, 2, 64)),
            ("f32_short", (1, 45, 3, 64))]


def bf16_cases():
    """bf16 (name, shape) cases for the bf16 backward mutants: the VDM
    step's ViT/frame shape, a DiT-like D = 128 one, ragged at both head dims
    and short."""
    return [("bf16_vit_frame", (13, 1029, 16, 64)),
            ("bf16_4096_d128", (1, 4096, 4, 128)),
            ("bf16_ragged_d64", (2, 1100, 2, 64)),
            ("bf16_ragged_d128", (2, 333, 3, 128)),
            ("bf16_short", (1, 45, 3, 64))]


def _mutate(text: str, name: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: the text to replace occurs "
                               f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    return text


def build_mutants(build, workdir: Path) -> dict[str, Path]:
    fwd = (build.CSRC_DIR / "flash_attention_fwd.cu").read_text()
    bwd = (build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    raster = (build.CSRC_DIR / "rasterize_bwd.cu").read_text()
    sources = {}
    for name, edits, text in (
            *((n, [e], fwd) for n, e in MUTANTS.items()),
            *((n, e, bwd) for n, e in BWD_MUTANTS.items()),
            *((n, e, bwd) for n, e in BF16_BWD_MUTANTS.items()),
            *((n, e, raster) for n, e in RASTER_MUTANTS.items())):
        src = workdir / f"{name}.cu"
        src.write_text(_mutate(text, name, edits))
        sources[name] = src

    def nvcc(item):
        name, src = item
        lib = src.with_suffix(".so")
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                               str(lib), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on mutant {name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        return name, lib
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(nvcc, sources.items()))


def run_cases(cs, fa, torch) -> list[dict]:
    rows = []
    for i, case in enumerate(cases(cs)):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        res, passed, _ = cs.compare_case(fa, case, gen)
        rows.append({**res, "passes": passed,
                     "passes_old_limit": res["max_abs_err_o"] <= OLD_O_ATOL
                     and res["max_abs_err_lse"] <= cs.LSE_ATOL})
    return rows


def run_f32_cases(cs, fa, torch) -> list[dict]:
    rows = []
    for i, (name, shape) in enumerate(f32_cases()):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        res, passed, _ = cs.compare_f32_case(fa, name, shape, gen)
        rows.append({**res, "passes": passed})
    return rows


def run_bf16_cases(cs, fa, torch) -> list[dict]:
    rows = []
    for i, (name, shape) in enumerate(bf16_cases()):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        res, passed, _ = cs.compare_bf16_bwd_case(fa, name, shape, gen)
        rows.append({**res, "passes": passed})
    return rows


def run_raster_case(cs, tr, torch) -> list[dict]:
    """One random scene at 448² (200,000 splats before an identity camera,
    opacities up to 0.99), the reward's pair budget, a random cotangent."""
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
    ntx = w // tr.TILE
    out = tr.composite(pairs.gid, pairs.bounds, table, ntx, w, w)
    gout = torch.randn(out.shape, generator=gen, device="cuda")
    res, passed, _ = cs.compare_composite_bwd(
        tr, pairs.gid, pairs.bounds, table, out, gout, ntx, w, w)
    return [{"case": "random_448", "pairs": pairs.gid.numel(), **res,
             "passes": passed}]


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
    import chip_smoke as cs
    from vist3a_tpu_torch.kernels import build
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import rasterizer as tr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    results, f32_results, bf16_results, raster_results = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="flash_mutants_") as tmp:
        t0 = time.perf_counter()
        fa._lib()                                   # the unchanged kernels
        fa._bwd_lib()
        tr._bwd_lib()
        built = build_mutants(build, Path(tmp))
        print(f"built {len(built)} mutants in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        own = build._loaded[fa.SOURCE]
        own_bwd = build._loaded[fa.BWD_SOURCE]
        own_raster = build._loaded[tr.BWD_SOURCE]
        try:
            for name, path in {"unchanged": None, **built}.items():
                lib = None if path is None else ctypes.CDLL(str(path))
                if name in BWD_MUTANTS or name in BF16_BWD_MUTANTS:
                    build._loaded[fa.BWD_SOURCE] = lib
                elif name in RASTER_MUTANTS:
                    build._loaded[tr.BWD_SOURCE] = lib
                elif lib is not None:
                    build._loaded[fa.SOURCE] = lib
                if name == "unchanged" or name in BF16_BWD_MUTANTS:
                    bf16_results[name] = run_bf16_cases(cs, fa, torch)
                    for r in bf16_results[name]:
                        print(f"{name:34s} {r['case']:17s} excess dQ "
                              f"{r['excess_dq']:.3g} dK {r['excess_dk']:.3g}"
                              f" dV {r['excess_dv']:.3g} passes "
                              f"{r['passes']}", flush=True)
                if name == "unchanged" or name in RASTER_MUTANTS:
                    raster_results[name] = run_raster_case(cs, tr, torch)
                    for r in raster_results[name]:
                        print(f"{name:34s} {r['case']:17s} off share "
                              f"{r['off_share']:.3g} max rel by column "
                              f"{r['max_rel_err_by_column']} passes "
                              f"{r['passes']}", flush=True)
                if name in BF16_BWD_MUTANTS or name in RASTER_MUTANTS:
                    build._loaded[fa.BWD_SOURCE] = own_bwd
                    build._loaded[tr.BWD_SOURCE] = own_raster
                    continue
                if name not in BWD_MUTANTS:
                    results[name] = run_cases(cs, fa, torch)
                    for r in results[name]:
                        print(f"{name:26s} {r['case']:15s} max|ΔO| "
                              f"{r['max_abs_err_o']:.6g} o_excess "
                              f"{r['o_excess']:.6g} "
                              f"max|ΔLSE| {r['max_abs_err_lse']:.6g} passes "
                              f"{r['passes']} (old 2e-2 limit: "
                              f"{r['passes_old_limit']})", flush=True)
                if name == "unchanged" or name in BWD_MUTANTS:
                    f32_results[name] = run_f32_cases(cs, fa, torch)
                    for r in f32_results[name]:
                        print(f"{name:26s} {r['case']:15s} rel|Δ| O "
                              f"{r['rel_err_o']:.3g} dQ {r['rel_err_dq']:.3g}"
                              f" dK {r['rel_err_dk']:.3g} dV "
                              f"{r['rel_err_dv']:.3g} passes {r['passes']}",
                              flush=True)
                build._loaded[fa.SOURCE] = own
                build._loaded[fa.BWD_SOURCE] = own_bwd
        finally:
            build._loaded[fa.SOURCE] = own
            build._loaded[fa.BWD_SOURCE] = own_bwd
            build._loaded[tr.BWD_SOURCE] = own_raster
    summary = {"device": smi, "o_atol_std": cs.O_ATOL_STD,
               "o_rtol": cs.O_RTOL, "old_o_atol": OLD_O_ATOL,
               "f32_limits": {"o_rtol": cs.F32_O_RTOL,
                              "grad_rtol": cs.F32_GRAD_RTOL,
                              "lse_atol": cs.F32_LSE_ATOL},
               "grad_limits": {"atol_std": cs.GRAD_ATOL_STD,
                               "rtol": cs.GRAD_RTOL},
               "raster_bwd_limits": {"rtol": cs.RASTER_BWD_RTOL,
                                     "max_off_share":
                                         cs.RASTER_BWD_MAX_OFF_SHARE},
               "results": results, "f32_results": f32_results,
               "bf16_results": bf16_results,
               "raster_results": raster_results}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    bad = [r["case"] for rows in (results["unchanged"],
                                  f32_results["unchanged"],
                                  bf16_results["unchanged"],
                                  raster_results["unchanged"])
           for r in rows if not r["passes"]]
    missed = [f"{name}/{r['case']}" for name, rows in results.items()
              if name != "unchanged" for r in rows
              if r["natural"] and r["passes"]]
    missed += [f"{name}/{r['case']}"
               for kind in (f32_results, bf16_results, raster_results)
               for name, rows in kind.items()
               if name != "unchanged" for r in rows if r["passes"]]
    print(json.dumps({"unchanged_fails": bad,
                      "mutant_cases_passed": missed}))
    return 1 if bad or missed else 0


if __name__ == "__main__":
    sys.exit(main())
