#!/usr/bin/env python3
"""What a training main leaves allocated on the card after it returns.

    python3 tools/torch_main_memory_probe.py [--root DIR]

Runs `vist3a_tpu_torch.cli.train_stitching.main` of the package under DIR
(default: this checkout; give an unpacked older tree to probe it) for one
step at tiny sizes on the card, twice: with `--wandb_logging` (where
`wandb.init` fails without an API key) and without.  The encoder and the
VAE are tiny modules handed in through the loaders; after each `main` it
prints, as one JSON line, the device memory allocated before and after
and whether the two modules are still alive once a garbage collection
ran, and, for a module still alive, the chain of objects that refer to it
(frames by function, file and line).
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import types
import weakref
from pathlib import Path

D = 32
CAMERA_BIAS = (0.05, -0.05, 0.5, 0.02, 0.03, 0.01, 0.25, 0.2, 0.2)


def referrers(obj, depth: int = 0, seen=None, max_depth: int = 7) -> None:
    """Print who refers to `obj`, a tree of types down to `max_depth`."""
    seen = set() if seen is None else seen
    if depth > max_depth:
        return
    for r in gc.get_referrers(obj):
        if id(r) in seen or r is seen:
            continue
        seen.add(id(r))
        desc = type(r).__name__
        if isinstance(r, types.FrameType):
            desc += (f" {r.f_code.co_name} {r.f_code.co_filename}:"
                     f"{r.f_lineno}")
        elif isinstance(r, dict):
            desc += " keys=" + str(list(r.keys())[:10])
        print("  " * depth + desc, flush=True)
        if not isinstance(r, types.ModuleType):
            referrers(r, depth + 1, seen, max_depth)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the folder holding the vist3a_tpu_torch to probe")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    from vist3a_tpu_torch.cli import arguments
    from vist3a_tpu_torch.cli import model_loading as ml
    from vist3a_tpu_torch.cli import train_stitching as cli
    from vist3a_tpu_torch.data import loader as loader_mod
    from vist3a_tpu_torch.nn import aggregator as tagg
    from vist3a_tpu_torch.nn import encoder as tenc
    from vist3a_tpu_torch.nn import heads as th
    from vist3a_tpu_torch.nn import vit as tvit
    from vist3a_tpu_torch.nn import wan_vae
    from vist3a_tpu_torch.nn.layers import build_random
    from vist3a_tpu_torch.stitch import chopped_anysplat as tca
    from vist3a_tpu_torch.train import stitching as tst

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    scfg = tca.StitchedConfig(
        encoder=tenc.EncoderConfig(
            vit=tvit.ViTConfig(img_size=56, embed_dim=D, depth=4,
                               num_heads=2),
            agg=tagg.AggregatorConfig(embed_dim=D, depth=4, num_heads=2,
                                      taps=(0, 1, 2, 3)),
            camera=th.CameraHeadConfig(dim_in=2 * D, trunk_depth=1,
                                       num_heads=2),
            depth=th.DPTConfig(dim_in=2 * D, features=16,
                               out_channels=(8, 16, 16, 16),
                               head2_features=8),
            gs=th.GSHeadConfig(dim_in=2 * D, features=16,
                               out_channels=(8, 16, 16, 16), output_dim=84,
                               head2_features=16, pos_embed=False)),
        stitch_layer_index=2, conv_spec=f"conv3d_k5x3x3_o{D}_s1x2x2_p2x1x1",
        vae=wan_vae.WanVAEConfig(base_dim=8, z_dim=16, num_res_blocks=1))
    tst.VIEW_COUNTS = (5,)
    refs = {}

    def encoder(root, cfg, device):
        m = build_random(lambda: tenc.Encoder(cfg),
                         torch.Generator(device).manual_seed(0), device,
                         torch.float32)
        with torch.no_grad():
            m.camera_head.pose_branch.fc2.bias.copy_(
                torch.tensor(CAMERA_BIAS))
        refs["encoder"] = weakref.ref(m)
        return m

    def vae(root, cfg, halves, device):
        m = wan_vae.init_encoder(scfg.vae,
                                 torch.Generator(device).manual_seed(1),
                                 device=device)
        refs["vae"] = weakref.ref(m)
        return {"encoder": m}
    ml.load_anysplat_encoder, ml.load_wan_vae = encoder, vae
    ml.stitched_config = lambda a: scfg
    ml.weights_root = lambda a: Path(".")
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-1, 1, (1, 3, 5, 56, 56)).astype(np.float32)
             for k in ("vae_image_tensor", "feedforward_image_tensor")}
    loader_mod.create_stitching_dataloader = lambda *a, **k: ([batch], None)
    tmp = tempfile.mkdtemp(prefix="vist3a_memory_probe_")
    for flag in ("--wandb_logging", "--no-wandb_logging"):
        refs.clear()
        a = arguments.stitching_training_argument().parse_args(
            ["--dataset", f"dl3dv:{tmp}", "--num_epochs", "1",
             "--lora_config", "r2,a4,d0.0,f0", "--save_path", tmp, flag])
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        cli.main(a, device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        alive = {k: r() is not None for k, r in refs.items()}
        print(json.dumps({"root": args.root, "flag": flag, "before": before,
                          "after": torch.cuda.memory_allocated(),
                          "alive": alive}), flush=True)
        held = refs["encoder"]()
        if held is not None:
            referrers(held)
        del held
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
