#!/usr/bin/env python3
"""Drive the PyTorch port (`vist3a_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels

Phases, each of which passes or raises (any failure exits non-zero):
  1. device  — the card's name and power limit; fails without CUDA.
  2. build   — builds `vist3a_tpu_torch/csrc/flash_attention_fwd.cu` for
               sm_90a and prints ptxas's registers / shared memory / spills.
  3. kernels — holds the flash-attention kernel against its plain PyTorch
               version at the three shapes of the decode (ViT blocks,
               frame attention, global attention), plus a fully masked and
               a strided case, and times it beside the plain version and
               `F.scaled_dot_product_attention` (a yardstick the port never
               calls).
  4. slice   — builds the stitched decoder at full width (VGGT-1B /
               DINOv2-L, random weights from a seed, trunk bf16, heads bf16)
               and serves 3 decode requests through `forward_with_latent`:
               Wan latent (1, 16, 4, 64, 64) + images (1, 3, 13, 448, 448)
               → 2,609,152 Gaussians.  Checks shapes, finiteness and that
               each request launched the kernel 8 times unmasked and 48
               times masked.
  5. profile — one more request under torch.profiler: device time by
               kernel and group, the device's busy share of the request,
               the host ops, and synchronised per-stage times.  Runs after
               the slice has read its launch counts.
  6. reference — a narrow decoder at the full spatial shape, run on the card
               (kernel path) and on the host CPU (plain path) with the same
               weights and inputs; the outputs must agree.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("device", "build", "kernels", "slice", "profile", "reference")
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
KERNEL_SOURCE = "vist3a_tpu_torch/csrc/flash_attention_fwd.cu"
O_ATOL = 2e-2     # bf16 output, P rounded to bf16 before the PV product
LSE_ATOL = 1e-3   # fp32 statistics; only the summation order differs

REQUESTS = 3
GAUSSIANS = 13 * 448 * 448
LAUNCHES_PER_REQUEST = {"unmasked": 8, "masked": 48}
# A pose-branch bias that puts the narrow decoder's random-weight cameras at
# a real pose (unit-ish quaternion, FoV ≈ 0.8 rad after 4 refinements):
# near-zero quaternions and ReLU-clipped FoVs would make the camera outputs
# ill-conditioned and the comparison meaningless.
CAMERA_BIAS = (0.05, -0.05, 0.5, 0.02, 0.03, 0.01, 0.25, 0.2, 0.2)


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

    t0 = time.perf_counter()
    fa._lib()
    log(f"build: {fa.SOURCE} loaded in {time.perf_counter() - t0:.1f} s")
    text = build.build_logs.get(fa.SOURCE, "(library already built)")
    for line in text.splitlines():
        if "ptxas" in line or "error" in line.lower():
            log(f"  {line.strip()}")


@dataclasses.dataclass
class Case:
    name: str
    b: int
    n: int
    h: int
    d: int
    n_invalid: int          # pad keys per frame of `frame_len`
    frame_len: int = 0      # 0: the pad keys sit at the end of the sequence


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


def check_case(fa, case: Case, gen, *, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

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
    res = {"case": case.name, "shape": list(shape), "masked": kv is not None,
           "max_abs_err_o": err_o, "max_abs_err_lse": err_lse}
    check(err_o <= O_ATOL and err_lse <= LSE_ATOL,
          f"kernel disagrees with flash_attention_ref: {res} "
          f"(atol O {O_ATOL}, LSE {LSE_ATOL})")
    if not timed:
        log(f"kernels: {json.dumps(res)}")
        return res

    n_live = case.n if kv is None else int(kv.sum().item())
    flops = 4.0 * case.b * case.n * n_live * case.h * case.d
    n_bytes = 4 * q.numel() * 2 + lse.numel() * 4 \
        + (0 if kv is None else kv.numel())
    bound_flops = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes = n_bytes / PEAK_BYTES * 1e3
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
    }
    # every key masked: O = 0, LSE = the finite sentinel −1e30·ln 2
    check_case(fa, Case("all_masked", 2, 130, 4, 64, 130), gen, timed=False)
    check_case(fa, Case("ragged_d128", 2, 333, 3, 128, 7), gen, timed=False)
    check_case(fa, Case("ragged_d40", 1, 77, 2, 40, 0), gen, timed=False)
    # strided inputs, read in place: q, k, v as views into one qkv tensor
    qkv = torch.randn(2, 1100, 3, 4, 64, generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    err = (o.float() - o_ref.float()).abs().max().item()
    check(err <= O_ATOL, f"strided inputs: max |ΔO| {err}")
    log(f"kernels: strided qkv views max_abs_err_o {err}")
    return timed


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


def phase_slice(profile: bool) -> dict:
    import torch

    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    cfg = stitched_config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = ca.init(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice: StitchedConfig() full width, {n_params} parameters, built "
        f"in {time.perf_counter() - t0:.1f} s")
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
        profile_request(model, cfg, *inputs[-1])
    return {"latency_ms": latencies, "peak_bytes": peak, "launches": counts}


def _kernel_group(name: str) -> str:
    low = name.lower()
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
    if any(t in low for t in ("sort", "radix", "quantile", "topk")):
        return "sort / quantile"
    if "layer_norm" in low or "layernorm" in low:
        return "layer norm"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled",
                              "reduce", "cat", "copy", "index", "fill")):
        return "elementwise / copy / reduce"
    return "other"


def profile_request(model, cfg, latent, images) -> None:
    """One request under torch.profiler: device time by kernel and group,
    and the device's busy share of the request's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ca.forward_with_latent(model, latent, images, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
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
    log(f"profile: request wall {wall_ms:.3f} ms (under the profiler), "
        f"device kernels {device_ms:.3f} ms, busy share "
        f"{device_ms / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile: group {g}: {ms:.3f} ms ({ms / device_ms:.4f})")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    for name, ms in top[:12]:
        log(f"profile: kernel {ms:9.3f} ms  {name[:110]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for ev in host[:12]:
        log(f"profile: host op {ev.self_cpu_time_total / 1e3:9.3f} ms self, "
            f"{ev.count:5d} calls  {ev.key[:90]}")
    stage_times(model, cfg, latent, images)


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
    return errs


def _kernel_entries(timed: dict, launches: dict) -> list:
    """One entry per kernel entry point (the two counters), each timed at
    its main-path shape; the masked entry's top-level numbers are those of
    the global shape, which holds 24 of its 48 launches and ~92 % of its
    FLOPs, and `shapes` carries every measured shape."""
    entries = []
    for kname, counter, line, cases in (
            ("flash_attention_fwd", "unmasked", 187, ("vit",)),
            ("flash_attention_fwd_masked", "masked", 756,
             ("global", "frame"))):
        rs = [timed[c] for c in cases if c in timed]
        if not rs:
            continue
        r = rs[0]
        entries.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"vist3a_tpu/kernels/flash_attention.py:{line}",
            "launches": launches[counter],
            "max_abs_err": max(x["max_abs_err_o"] for x in rs),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "shapes": [{k: x[k] for k in ("case", "shape", "kernel_ms",
                                          "plain_ms", "bound_ms",
                                          "library_ms", "max_abs_err_o",
                                          "max_abs_err_lse")}
                       for x in rs]})
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

    name = phase_device()
    if "build" in phases:
        phase_build()
    timed = phase_kernels() if "kernels" in phases else {}
    sliced = phase_slice("profile" in phases) if "slice" in phases else None
    if "reference" in phases:
        phase_reference()

    launches = sliced["launches"] if sliced else {"unmasked": None,
                                                   "masked": None}
    print(json.dumps({"kernels": _kernel_entries(timed, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
