#!/usr/bin/env python3
"""Time the composite kernels beside their predecessors and beside probe
variants, on the full-width orbit views of `chip_smoke.py` phase `raster`
(needs one NVIDIA GPU and nvcc).

    python3 tools/torch_composite_probe.py --parent DIR [--out FILE]

DIR holds the predecessor's `rasterize_fwd.cu` and `rasterize_bwd.cu`
(with any header they include), for example the `csrc/` of a `git archive`
of the parent commit unpacked into a gitignored directory.  Built in a
temporary directory, one nvcc each, all at once:
  * `parent_fwd`, `parent_bwd`: the predecessors;
  * `fwd_cull_off`, `bwd_cull_off`: the repository's kernels with the cull
    mask of `csrc/raster_common.cuh` forced to all bits (every warp walks
    every pair);
  * timed only, their outputs wrong by design: `bwd_no_reduce`, the
    backward with its reduce-scatter and partial sums cut out (each lane
    sums its contributions into a register that is never stored);
    `bwd_no_sum`, the backward without its cross-warp sum and row writes;
    `fwd_stage_only`, `bwd_stage_only`, the kernels staging every batch
    (ids, rows, masks, barriers) and walking none.
Another variant is one more entry of `VARIANTS`: a source and the text
edits that make it.
On each orbit view of `chip_smoke.RASTER_VIEWS` (the forward at the
default pair budget, the backward at the reward's 1×G budget with a random
cotangent), the kernels of one direction are timed in turns — the parent,
the kernel, the variants, then the same in reverse — 20 launches each
(CUDA events), and each time is the mean of its two turns.  The kernel's
outputs are compared with the parent's (max |Δ| and whether equal) and the
variants' with the kernel's; each variant but the timed-only ones is also
held against the plain version by `chip_smoke`'s comparisons (off share).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FWD, BWD, HEADER = "rasterize_fwd.cu", "rasterize_bwd.cu", "raster_common.cuh"
ITERS = 20

# variant → (source, {file: [(text, replacement), ...]})
CULL_OFF = {HEADER: [("  return mask;\n}", "  return kAllWarps;\n}")]}
NO_REDUCE = [(
    "      const int v = reduce_scatter(c, lane);\n",
    "      float z = 0.f;\n#pragma unroll\n"
    "      for (int k = 0; k < kValues; ++k) z += c[k];\n"
    "      if (z == 1234.5f) sm.part[warp][0][0] = z;\n"
    "      const int v = -1;\n")]
NO_SUM = [("      dpair[static_cast<size_t>(base + j) * kAttr + k] = sum;\n",
           "      if (sum == 1234.5f) dpair[0] = sum;\n")]
STAGE_ONLY = [("    const int n = min(kBatch, end - base);\n",
               "    const int n = 0;\n")]
VARIANTS = {"fwd_cull_off": (FWD, CULL_OFF),
            "fwd_stage_only": (FWD, {FWD: STAGE_ONLY}),
            "bwd_cull_off": (BWD, CULL_OFF),
            "bwd_no_reduce": (BWD, {BWD: NO_REDUCE}),
            "bwd_no_sum": (BWD, {BWD: NO_SUM}),
            "bwd_stage_only": (BWD, {BWD: STAGE_ONLY})}
# timed only: their outputs are wrong by design
TIMED_ONLY = ("fwd_stage_only", "bwd_no_reduce", "bwd_no_sum",
              "bwd_stage_only")


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"probe edit found {text.count(old)} times: "
                               f"{old!r}")
        text = text.replace(old, new)
    return text


def build_libs(build, parent: Path, workdir: Path) -> dict[str, Path]:
    """Name → built library of each predecessor and variant."""
    jobs = {}
    for name, src in (("parent_fwd", FWD), ("parent_bwd", BWD)):
        jobs[name] = (parent / src, parent)
    for name, (src, edits) in VARIANTS.items():
        folder = workdir / name
        folder.mkdir()
        for file in {src, *edits}:
            text = (build.CSRC_DIR / file).read_text()
            (folder / file).write_text(_edit(text, edits.get(file, [])))
        jobs[name] = (folder / src, build.CSRC_DIR)

    def nvcc(item):
        name, (src, include) = item
        lib = workdir / f"lib{name}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                               "-I", str(include), "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        return name, lib
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return dict(pool.map(nvcc, jobs.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory with the predecessor's sources")
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_composite_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from vist3a_tpu_torch.kernels import build
    from vist3a_tpu_torch.kernels import rasterizer as tr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    tr._lib()
    tr._bwd_lib()
    own = dict(build._loaded)

    results = {"device": smi, "iters": ITERS, "views": []}
    with tempfile.TemporaryDirectory(prefix="composite_probe_") as tmp:
        libs = {name: ctypes.CDLL(str(path)) for name, path in
                build_libs(build, args.parent.resolve(),
                           Path(tmp)).items()}
        model = cs.build_stitched()
        gaussians, cams = cs.raster_scene(model)
        del model
        g = gaussians
        n_gauss = g.means.shape[1]
        ntx = cs.IMAGE // tr.TILE
        try:
            for view in cs.RASTER_VIEWS:
                viewmat, K = cs.orbit_view(cams, view)
                row = {"view": view}
                for direction, budget, source in (
                        ("fwd", tr.default_pair_budget(n_gauss), tr.SOURCE),
                        ("bwd", cs.stitched_config().latent_t * cs.IMAGE ** 2,
                         tr.BWD_SOURCE)):
                    names = (f"parent_{direction}", "kernel",
                             *(n for n, v in VARIANTS.items()
                               if v[0] == source))
                    table, pairs = tr.view_pairs(
                        g.means[0], g.covariances[0], g.harmonics[0],
                        g.opacities[0], viewmat, K, cs.IMAGE, cs.IMAGE,
                        budget)
                    fargs = (pairs.gid, pairs.bounds, table, ntx, cs.IMAGE,
                             cs.IMAGE)
                    if direction == "fwd":
                        call = lambda: tr.composite(*fargs)       # noqa: E731
                    else:
                        out = tr.composite(*fargs)
                        gen = torch.Generator(device="cuda").manual_seed(
                            30 + view)
                        gout = torch.randn(out.shape, generator=gen,
                                           device="cuda")
                        call = lambda: tr.composite_bwd(          # noqa: E731
                            *fargs[:3], out, gout, *fargs[3:])

                    def use(name):
                        build._loaded[source] = libs.get(name, own[source])

                    times = {n: [] for n in names}
                    outputs = {}
                    for name in (*names, *reversed(names)):
                        use(name)
                        outputs.setdefault(name, call())
                        times[name].append(cs.cuda_events_ms(call, ITERS))
                    off_share = {}
                    for name in names[1:]:
                        if name in TIMED_ONLY:
                            continue
                        use(name)
                        if direction == "fwd":
                            res, _, _ = cs.compare_composite(tr, *fargs)
                        else:
                            res, _, _ = cs.compare_composite_bwd(
                                tr, *fargs[:3], out, gout, *fargs[3:])
                        off_share[name] = res["off_share"]
                    use("kernel")
                    torch.cuda.synchronize()
                    ms = {n: sum(t) / len(t) for n, t in times.items()}
                    mine = outputs["kernel"]
                    row[direction] = {
                        "pairs": pairs.gid.numel(), "ms": ms, "turns": times,
                        "kernel_vs_parent": ms["kernel"] / ms[names[0]],
                        "max_abs_diff": {
                            n: (outputs[n] - mine).abs().max().item()
                            for n in names if n != "kernel"},
                        "equal_to_kernel": {
                            n: torch.equal(outputs[n], mine)
                            for n in names if n != "kernel"},
                        "off_share_vs_plain": off_share}
                    print(f"probe: view {view} {direction} "
                          f"{json.dumps(row[direction])}", flush=True)
                results["views"].append(row)
        finally:
            build._loaded.update(own)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps({v["view"]: {d: v[d]["kernel_vs_parent"]
                                  for d in ("fwd", "bwd")}
                      for v in results["views"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
