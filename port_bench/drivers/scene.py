"""Driver `scene`: whole text→3DGS scenes back to back, one client in a
closed loop, at B = 1 with the CFG pair batched to 2.

Each scene runs the four stages that `pipelines/t23d.py::text_to_3dgs`
is made of, each inside a span of the benchmark's own (`bench.embed`,
`bench.denoise`, `bench.decode`, `bench.export`, within `bench.scene`):
the prompt embeddings, the 50 UniPC steps, the VAE and stitched decoder,
and the export, which renders the orbit and writes gs.mp4, depth.mp4 and
gaussians.ply into a folder under TMPDIR that is deleted after the scene.
The scene in flight when the window's time runs out completes and counts.
With --trace 1 the window's first scene runs under the profiler and the
spans close with a synchronize.

Scene i's prompt and noise are drawn from the run's seed and i; every
scene has the same sizes.  After the window, one finished scene, drawn
from the seed, is worked out again by the plain reference and compared
stage by stage (`compare`).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import common, t23d_parts as parts
from port_bench import trace as trace_mod

# the scene the check compares is drawn from the first KEEP_FROM finished
# (a window of the cell's length finishes more)
KEEP_FROM = 3
# the warm-up scene's index: its inputs are drawn apart from the window's
WARM_INDEX = 1_000_000


def one_scene(run, mods, cfg, i: int, folder: str) -> dict:
    from vist3a_tpu_torch.pipelines import t23d

    prompt, z = parts.request_inputs(run, cfg, i)
    tok = run.state["tokenize"]
    size = cfg.feedforward_size
    with parts.span(run, "bench.scene", i):
        with parts.span(run, "bench.embed", i):
            cond, uncond = t23d.embed_prompts(mods["umt5"], tok, prompt,
                                              device=run.device)
        with parts.span(run, "bench.denoise", i):
            lat = t23d.denoise(mods["dit"], cond, uncond, cfg, latents0=z,
                               device=run.device)
        with parts.span(run, "bench.decode", i):
            out, video = t23d.decode_and_reconstruct(
                mods["vae"], mods["stitched"], lat, cfg, device=run.device)
        with parts.span(run, "bench.export", i):
            arts = t23d.export_artifacts(
                out.gaussians, out.extrinsic_c2w, out.intrinsic_norm, folder,
                (size, size), orbit_t=run.config["orbit_t"],
                device=run.device)
    return {"index": i, "prompt": prompt, "cond": cond, "uncond": uncond,
            "latents": lat, "video": video, "out": out, "arts": arts,
            "folder": folder}


def setup(run) -> None:
    cfg = parts.program_config(run)
    run.state["cfg"] = cfg
    run.state["tokenize"] = common.tokenizer(cfg.umt5.max_sequence_length,
                                             cfg.umt5.vocab_size)
    t0 = time.perf_counter()
    run.state["mods"] = parts.build_program(run, cfg)
    common.sync(run.device)
    t1 = time.perf_counter()
    run.state["tmp"] = tempfile.mkdtemp(prefix="port_bench_scene_")
    # every shape of the traffic: one whole scene (its own index)
    warm = one_scene(run, run.state["mods"], cfg, WARM_INDEX,
                     os.path.join(run.state["tmp"], "warm"))
    shutil.rmtree(warm["folder"], ignore_errors=True)
    run.spans.clear()
    parts.log_setup(run, t0, t1)


def window(run) -> None:
    cfg, mods = run.state["cfg"], run.state["mods"]
    keep_at = int(common.rng(run.seed, 3).integers(KEEP_FROM))
    kept = None
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < run.seconds:
        folder = os.path.join(run.state["tmp"], f"scene{i}")
        if run.trace and i == 0:
            before = parts.launch_counts()
            res, run.trace_data = trace_mod.traced(
                lambda: one_scene(run, mods, cfg, i, folder))
            after = parts.launch_counts()
            run.counters["traced_launches"] = {
                k: after[k] - before[k] for k in after}
        else:
            res = one_scene(run, mods, cfg, i, folder)
        if i == 0:
            # nothing of the benchmark's is held yet: the program's peak
            run.counters["scene_peak_bytes"] = common.max_allocated(
                run.device)
        run.attempted += 1
        if kept is None or kept["index"] < keep_at:
            if kept is not None:
                shutil.rmtree(kept["folder"], ignore_errors=True)
            kept = res
        else:
            shutil.rmtree(folder, ignore_errors=True)
        del res
        i += 1
    common.sync(run.device)
    wall = time.perf_counter() - t0
    run.e2e["scene_s"] = wall / i
    run.state["kept"] = kept
    run.counters["scenes"] = i


def free(run) -> None:
    run.state.pop("mods", None)
    common.empty_cache(run.device)


def produced(run, views) -> dict:
    """What the program produced in the kept scene, in the form `compare`
    reads: the files read back from the folder."""
    k = run.state["kept"]
    out, arts = k["out"], k["arts"]
    from port_bench.reference.scene import load_ply

    return {"cond": k["cond"], "uncond": k["uncond"], "latents": k["latents"],
            "video": k["video"], "out": out,
            "color": torch.from_numpy(np.asarray(arts.color[views])),
            "depth": torch.from_numpy(np.asarray(arts.depth[views])),
            "ply": torch.from_numpy(load_ply(arts.ply_path).copy()),
            "mp4_off": mp4_off(arts, len(arts.color))}


def mp4_off(arts, n_frames: int) -> float:
    """How far both mp4s are from n_frames frames of the rendered size:
    frames missing or extra, plus one for a wrong size (0 when whole)."""
    want = (n_frames, *arts.color.shape[2:], 3)
    return float(sum(abs(len(v) - n_frames) + (tuple(v.shape) != want)
                     for v in (read_mp4(arts.gs_path),
                               read_mp4(arts.depth_path))))


def read_mp4(path: str) -> np.ndarray:
    """Every frame of an mp4 as (N, H, W, 3) uint8 RGB, read with imageio
    (ffmpeg) or else OpenCV, as the program writes them."""
    try:
        import imageio

        reader = imageio.get_reader(path)
        frames = [np.asarray(f) for f in reader]
        reader.close()
    except (ImportError, ValueError):
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f[..., ::-1])
        cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)


def sample_views(run, n_views: int) -> list[int]:
    """Three orbit views drawn from the seed."""
    return sorted(int(v) for v in common.rng(run.seed, 4).choice(
        n_views, size=3, replace=False))


def reference_stages(run, got: dict) -> dict:
    """The float32 reference of each stage of the kept scene, from the
    benchmark's inputs and, past the first stage, from what the program
    (or the control in its place) gave the stage before: the prompt
    embeddings from the token ids; the 50 UniPC steps from `got`'s
    embeddings and the scene's noise; the VAE video, Gaussians and cameras
    from `got`'s latents; the confidence mask and the opacities from
    `got`'s depth confidence and raw Gaussian features; the orbit views
    from `got`'s Gaussians and cameras; the PLY rows from `got`'s
    Gaussians."""
    from port_bench.reference import scene as ref

    rcfg, mods = parts.ref_modules(run, torch.float32, "float32", False)
    prompt, z = parts.request_inputs(run, rcfg, run.state["kept"]["index"])
    cond, uncond = ref.embed(mods.pop("umt5"), run.state["tokenize"], prompt,
                             run.device)
    common.empty_cache(run.device)
    lat = ref.denoise(mods.pop("dit"), got["cond"].float(),
                      got["uncond"].float(), rcfg, z)
    common.empty_cache(run.device)
    out, video = ref.decode(mods.pop("vae"), mods.pop("stitched"),
                            got["latents"].float(), rcfg, run.device)
    common.empty_cache(run.device)
    mask, opacities = ref.mask_and_opacities(
        got["out"], rcfg.stitched.encoder.conf_threshold)
    color, depth = ref.render_views(got["out"], run.state["views"],
                                    rcfg.feedforward_size,
                                    run.config["orbit_t"], run.device)
    return {"cond": cond, "uncond": uncond, "latents": lat, "video": video,
            "out": out, "mask": mask, "opacities": opacities,
            "color": color, "depth": depth,
            "ply": torch.from_numpy(ref.ply_fields(got["out"].gaussians))}


def control_scene(run) -> dict:
    """The control in the program's place, in the form `compare` reads:
    the reference one precision below what the configuration states — in
    bf16 over weights rounded to float8 e4m3 for the bf16 models, the
    confidence mask and opacities assembled in bf16 and the orbit rendered
    from bf16-rounded Gaussians and cameras for the fp32 assembly and
    renderer — and its PLY rows by the reference's transform (it writes no
    file)."""
    from port_bench.reference import scene as ref

    rcfg, mods = parts.ref_modules(run, torch.bfloat16, "bfloat16", True)
    prompt, z = parts.request_inputs(run, rcfg, run.state["kept"]["index"])
    cond, uncond = ref.embed(mods.pop("umt5"), run.state["tokenize"], prompt,
                             run.device)
    lat = ref.denoise(mods.pop("dit"), cond, uncond, rcfg, z)
    out, video = ref.decode(mods.pop("vae"), mods.pop("stitched"), lat, rcfg,
                            run.device)
    common.empty_cache(run.device)
    mask, opacities = ref.mask_and_opacities(
        out, rcfg.stitched.encoder.conf_threshold, torch.bfloat16)
    out = out._replace(conf_valid_mask=mask, gaussians=out.gaussians._replace(
        opacities=opacities))
    color, depth = ref.render_views(out, run.state["views"],
                                    rcfg.feedforward_size,
                                    run.config["orbit_t"], run.device,
                                    bf16=True)
    return {"cond": cond, "uncond": uncond, "latents": lat, "video": video,
            "out": out, "color": color, "depth": depth,
            "ply": torch.from_numpy(ref.ply_fields(out.gaussians)),
            "mp4_off": 0.0}


PLY_GROUPS = {"xyz": slice(0, 3), "normals": slice(3, 6),
              "f_dc": slice(6, 9), "opacity": slice(9, 10),
              "scale": slice(10, 13), "rot": slice(13, 17)}
GAUSSIAN_FIELDS = ("means", "covariances", "harmonics", "opacities")


def compare(got: dict, want: dict) -> dict:
    """The numbers compared: relative L2 errors against the reference of
    each stage — the Gaussians' means, covariances and harmonics, and the
    raw Gaussian features before the confidence mask (the opacity logits
    among them); the confidence mask's share of pixels that differ from
    the mask the configuration's quantile makes of the program's own depth
    confidence, and the opacities against those assembled from the
    program's own features and that mask (the mask is the 10 % quantile of
    the depth confidence, and a pixel that crosses it flips its opacity to
    or from 0 at any precision, so the opacities are not held against the
    reference's; that share and the opacities where the masks agree are
    detail); the PLY's largest absolute difference from the rows the
    reference derives from the same Gaussians, and the mp4s' frame count
    and size against the render's (exact comparisons).  Keys with a "d."
    prefix are detail for the sweep's log only."""
    rel = common.rel
    g, w = got["out"], want["out"]
    dev = want["latents"].device
    detail = {f"d.{f}": rel(getattr(g.gaussians, f).to(dev),
                            getattr(w.gaussians, f))
              for f in GAUSSIAN_FIELDS}
    detail["d.extrinsic"] = rel(g.extrinsic_c2w.to(dev), w.extrinsic_c2w)
    detail["d.intrinsic"] = rel(g.intrinsic_norm.to(dev), w.intrinsic_norm)
    gm = g.conf_valid_mask.to(dev).flatten()
    wm = w.conf_valid_mask.flatten()
    agree = gm == wm
    detail["d.opacities_agree"] = rel(
        g.gaussians.opacities.to(dev).flatten()[agree],
        w.gaussians.opacities.flatten()[agree])
    detail["d.mask_flips"] = float((~agree).float().mean())
    mask_off = float((g.conf_valid_mask.to(dev).flatten()
                      != want["mask"].to(dev).flatten()).float().mean()) \
        if g.conf_valid_mask.shape == want["mask"].shape else float("inf")
    return {
        "embed_rel": rel(torch.cat([got["cond"], got["uncond"]]).to(dev),
                         torch.cat([want["cond"], want["uncond"]])),
        "latents_rel": rel(got["latents"].to(dev), want["latents"]),
        "video_rel": rel(got["video"].to(dev), want["video"]),
        "gaussians_rel": max(detail[f"d.{f}"] for f in
                             ("means", "covariances", "harmonics")),
        "gs_feats_rel": rel(g.anchor_feats.to(dev), w.anchor_feats),
        "cameras_rel": max(detail["d.extrinsic"], detail["d.intrinsic"]),
        "mask_off": mask_off,
        "opacity_rel": rel(g.gaussians.opacities.to(dev),
                           want["opacities"]),
        "frames_rel": rel(got["color"].to(dev), want["color"]),
        "depth_rel": rel(got["depth"].to(dev), want["depth"]),
        "ply_maxabs": float((got["ply"] - want["ply"]).abs().max()),
        "mp4_off": got["mp4_off"],
        **detail,
    }


def _prepare(run) -> None:
    cfg = run.state.get("cfg") or parts.program_config(run)
    run.state["cfg"] = cfg
    run.state.setdefault("tokenize", common.tokenizer(
        cfg.umt5.max_sequence_length, cfg.umt5.vocab_size))
    n_views = (cfg.num_frames - 1) * (run.config["orbit_t"] + 1) + 1
    run.state["views"] = sample_views(run, n_views)


def check(run) -> list:
    _prepare(run)
    got = produced(run, run.state["views"])
    run.state["kept"] = {"index": run.state["kept"]["index"]}
    shutil.rmtree(run.state.pop("tmp"), ignore_errors=True)
    common.empty_cache(run.device)
    numbers = compare(got, reference_stages(run, got))
    limits = run.cell["limits"]
    return [(n, numbers[n], limits[n]) for n in limits]


def sweep_seed(run, program: bool, control: bool) -> dict:
    """`sweep.py`'s readings for one seed: the program's numbers (one
    untimed scene, the one a run of this seed would compare) and the
    control's, each against the reference of its own stages."""
    _prepare(run)
    keep_at = int(common.rng(run.seed, 3).integers(KEEP_FROM))
    run.state["kept"] = {"index": keep_at}
    numbers = {}
    if program:
        mods = parts.build_program(run, run.state["cfg"])
        run.state["tmp"] = tempfile.mkdtemp(prefix="port_bench_sweep_")
        run.state["kept"] = one_scene(run, mods, run.state["cfg"], keep_at,
                                      os.path.join(run.state["tmp"], "scene"))
        del mods
        common.empty_cache(run.device)
        got = produced(run, run.state["views"])
        run.state["kept"] = {"index": keep_at}
        shutil.rmtree(run.state.pop("tmp"), ignore_errors=True)
        numbers["program"] = compare(got, reference_stages(run, got))
        del got
        common.empty_cache(run.device)
    if control:
        got = control_scene(run)
        common.empty_cache(run.device)
        numbers["control"] = compare(got, reference_stages(run, got))
    return numbers
