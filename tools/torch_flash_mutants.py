#!/usr/bin/env python3
"""Plant faults in the port's flash-attention kernel and check that
`chip_smoke.py`'s tolerance catches them (needs one NVIDIA GPU and nvcc).

    python3 tools/torch_flash_mutants.py [--out results.json]

Each mutant is `csrc/flash_attention_fwd.cu` with one textual change on the
PV side of the kernel, where a fault can leave the LSE untouched, so only
the O check can see it.  The mutated sources are written to and built in a
fresh temporary directory (the checkout is not touched), one nvcc each, all
at once.  Every library — the unchanged source first — is loaded in place of
the kernel's own and driven through the wrapper `flash_attention_fwd` at the
cases of `chip_smoke.py` on the same seeded inputs; each case is judged by
`chip_smoke.compare_case` (each |ΔO| within `O_ATOL_STD` of the plain
output's std plus `O_RTOL` of itself, LSE within `LSE_ATOL`) and, for
comparison, by the fixed O limit of 2e-2 that the script used before.  The
script fails unless the unchanged kernel passes every case and every
mutant fails the scaled limit on the natural (head_dim 128) cases.
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
# name → (text of the unchanged source, its replacement)
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


def build_mutants(build, workdir: Path) -> dict[str, Path]:
    text = (build.CSRC_DIR / "flash_attention_fwd.cu").read_text()
    sources = {}
    for name, (old, new) in MUTANTS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: the text to replace occurs "
                               f"{text.count(old)} times in the source")
        src = workdir / f"{name}.cu"
        src.write_text(text.replace(old, new))
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="flash_mutants_") as tmp:
        t0 = time.perf_counter()
        fa._lib()                                   # the unchanged kernel
        libs = {"unchanged": None, **build_mutants(build, Path(tmp))}
        print(f"built {len(libs) - 1} mutants in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        own = build._loaded[fa.SOURCE]
        try:
            for name, path in libs.items():
                build._loaded[fa.SOURCE] = own if path is None \
                    else ctypes.CDLL(str(path))
                results[name] = run_cases(cs, fa, torch)
                for r in results[name]:
                    print(f"{name:24s} {r['case']:15s} max|ΔO| "
                          f"{r['max_abs_err_o']:.6g} o_excess "
                          f"{r['o_excess']:.6g} "
                          f"max|ΔLSE| {r['max_abs_err_lse']:.6g} passes "
                          f"{r['passes']} (old 2e-2 limit: "
                          f"{r['passes_old_limit']})", flush=True)
        finally:
            build._loaded[fa.SOURCE] = own
    summary = {"device": smi, "o_atol_std": cs.O_ATOL_STD,
               "o_rtol": cs.O_RTOL,
               "old_o_atol": OLD_O_ATOL, "results": results}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    bad = [r["case"] for r in results["unchanged"] if not r["passes"]]
    missed = [f"{name}/{r['case']}" for name, rows in results.items()
              if name != "unchanged" for r in rows
              if r["natural"] and r["passes"]]
    print(json.dumps({"unchanged_fails": bad,
                      "mutant_natural_cases_passed": missed}))
    return 1 if bad or missed else 0


if __name__ == "__main__":
    sys.exit(main())
