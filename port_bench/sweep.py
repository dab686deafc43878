"""The readings behind a cell's limits: the program's numbers and the
control's on many seeds, in one process.

    python3 -m port_bench.sweep --workload <cell> --seeds 11,12,13 \
        [--control 11,12,13] --out sweep.jsonl

For each seed it runs, untimed, the scene the benchmark's check would
compare (its index drawn from the seed as in the run), works it out again
with the plain float32 reference, and compares the two with the cell's
`compare`.  For each seed of --control it also puts the control in the
program's place — the reference computed in bf16 over weights rounded to
float8 e4m3, the step below the bf16 the configuration states — and
compares it with the same reference.  One JSON line per seed and side.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import common, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell = common.cell(args.workload)
    config = common.config_file(cell["config"])
    drv = harness.load_driver(cell)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control.split(",") if s]
    with open(args.out, "a") as log:
        for seed in sorted(set(seeds) | set(controls)):
            run = harness.Run(args.workload, seed, 0.0, False, cell, config,
                              time.perf_counter())
            t0 = time.perf_counter()
            numbers = drv.sweep_seed(run, seed in seeds, seed in controls)
            for side, nums in numbers.items():
                line = {"workload": args.workload, "seed": seed,
                        "side": side, "numbers": nums,
                        "seconds": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                log.write(json.dumps(line) + "\n")
                log.flush()
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
