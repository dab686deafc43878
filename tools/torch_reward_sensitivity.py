#!/usr/bin/env python3
"""How far the narrow VDM step's reward gradient moves on the host CPU
alone when its input moves by a relative 1e-6, free and with the render's
inputs pinned (no GPU needed).

    python3 tools/torch_reward_sensitivity.py [--noise 1e-6] [--threads 4]

Builds `chip_smoke.narrow_vdm_setup()` (the models of phase `vdm`'s
narrow card-vs-host comparison) and runs `chip_smoke.narrow_reward_grads`
three times per precision: from the latent as drawn (A); from the latent
times 1 + noise·N(0, 1) (B); and B again with the decoded clip, the
Gaussians and the cameras pinned to A's values (their gradients still
flowing through B's graph).  Once with the stitched trunk and the VAE
activations in fp32, once in the deployed bf16.  Prints, per precision,
the losses and ‖Δ‖/‖g‖ against A of each gradient (with respect to the
latent through the stitched decoder, to the decoded clip, and the whole),
free and pinned, as one JSON line each.  A change at fp32 rounding moves
bf16 activations across rounding boundaries, so the free spread is what a
card-vs-host comparison of the branch meets from rounding alone, and the
pinned one what is left once both sides' render sees the same inputs.
"""


from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", type=float, default=1e-6)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    torch.set_num_threads(args.threads)
    setup = cs.narrow_vdm_setup()
    bf16 = setup["models"]["stitched"]
    variants = {"fp32": (copy.deepcopy(bf16).float(), torch.float32),
                "bf16": (bf16, torch.bfloat16)}
    for name, (stitched, vae_dtype) in variants.items():
        t0 = time.perf_counter()
        loss0, g0, values = cs.narrow_reward_grads(setup, "cpu", stitched,
                                                   vae_dtype)
        runs = {"free": cs.narrow_reward_grads(
                    setup, "cpu", stitched, vae_dtype, noise=args.noise),
                "pinned": cs.narrow_reward_grads(
                    setup, "cpu", stitched, vae_dtype, noise=args.noise,
                    pin={k: values[k] for k in ("video", "values")})}
        print(json.dumps({
            "precision": name, "noise": args.noise, "loss": loss0,
            **{f"{kind}_loss": r[0] for kind, r in runs.items()},
            **{f"{kind}_grad_rel_dist": {
                k: cs.rel_dist({k: r[1][k]}, {k: g}) for k, g in g0.items()}
               for kind, r in runs.items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
