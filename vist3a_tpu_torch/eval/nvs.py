"""RE10K novel-view-synthesis bench: two-pass inference, scale alignment,
target-view rendering, per-sequence metrics.

Port of `vist3a_tpu/eval/nvs.py` (the reference's
`evaluation/novel_view_synthesis_bench/nvs_eval.py` and
`calculate_metric.py`):

  * the targets are the last 4 ids, reversed (:180);
  * pass 1: the context views, the last one duplicated (:93-99), through
    the stitched model → Gaussians and context poses;
  * pass 2: context (with the duplicate) and targets → every pose; the
    target translations scaled by the ratio of the passes' mean context
    translations (:131-140), in host numpy on the fp32 arrays, in the JAX
    package's order;
  * the targets rendered at `render_hw` (`nn/splat_decoder.py::render`:
    the composite kernel, one launch a view);
  * gt / pred PNGs per sequence; PSNR / SSIM (/ LPIPS) over the saved
    PNGs into a per-sequence and an overall CSV.

PNGs are written with PIL where it imports and with OpenCV otherwise
(RGB → BGR); both write the same pixels.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from vist3a_tpu_torch.data.preprocessing import load_rgb
from vist3a_tpu_torch.eval import metrics
from vist3a_tpu_torch.nn.splat_decoder import render
from vist3a_tpu_torch.stitch import chopped_anysplat as ca


def target_view_indices(ids) -> list[int]:
    """The last 4 ids, reversed (`nvs_eval.py:180`)."""
    return list(range(len(ids)))[::-1][:4]


def inference_nvs(models: dict, images01: np.ndarray,
                  vae_images01: np.ndarray, target_view_index: list[int],
                  scfg: ca.StitchedConfig, *, render_hw=(448, 448),
                  pair_budget: int | None = None, forward_fn=None,
                  device: torch.device | str = "cuda") -> np.ndarray:
    """images01: (V, 3, h, w) feed-forward frames in [0, 1]; vae_images01:
    (V, 3, H, W) VAE-size frames.  Returns the predicted target views
    (T, 3, H', W') in [0, 1].

    forward_fn(vae_pm1 (1, 3, S, H, W), ff_pm1 (1, 3, S, h, w)), CPU fp32
    tensors in [−1, 1] → EncoderOutput; by default the pixel-input stitched
    forward (`ca.forward_from_video`) of models {"stitched",
    "vae_encoder"} on `device`."""
    if forward_fn is None:
        def forward_fn(vae_pm1, ff_pm1):
            return ca.forward_from_video(models["stitched"],
                                         models["vae_encoder"], vae_pm1,
                                         ff_pm1, scfg, device=device)

    v = images01.shape[0]
    source = [i for i in range(v) if i not in target_view_index]

    def stack(arr, idx, dup_last):
        sel = arr[idx]
        if dup_last:
            sel = np.concatenate([sel, sel[-1:]], axis=0)
        # (S, 3, H, W) → (1, 3, S, H, W) in [−1, 1]
        return torch.from_numpy(np.ascontiguousarray(
            sel.transpose(1, 0, 2, 3)[None] * 2.0 - 1.0))

    # pass 1: context only (+ the duplicate) → Gaussians + context poses
    ctx_out = forward_fn(stack(vae_images01, source, True),
                         stack(images01, source, True))
    n_ctx = len(source) + 1

    # pass 2: context (+ the duplicate) + targets → every pose
    order = source + [source[-1]] + list(target_view_index)
    all_out = forward_fn(stack(vae_images01, order, False),
                         stack(images01, order, False))
    all_ex = all_out.extrinsic_c2w.float().cpu().numpy()
    all_k = all_out.intrinsic_norm.float().cpu().numpy()
    del all_out
    ctx_ex_pass2 = all_ex[:, :n_ctx]
    tgt_ex = all_ex[:, n_ctx:].copy()
    tgt_k = all_k[:, n_ctx:]

    # translation scale alignment (`nvs_eval.py:131-140`)
    scale = (ctx_out.extrinsic_c2w.float().cpu().numpy()[:, :, :3, 3].mean()
             / ctx_ex_pass2[:, :, :3, 3].mean())
    tgt_ex[..., :3, 3] *= scale

    with torch.inference_mode():
        out = render(ctx_out.gaussians, torch.from_numpy(tgt_ex),
                     torch.from_numpy(np.ascontiguousarray(tgt_k)),
                     render_hw, pair_budget=pair_budget,
                     device=ctx_out.gaussians.means.device)
    return out.color[0].cpu().numpy()


def save_image(img01: np.ndarray, path) -> None:
    """(3, H, W) [0, 1] → PNG."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = (np.clip(img01.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        Image.fromarray(arr).save(path)
        return
    import cv2

    if not cv2.imwrite(str(path), np.ascontiguousarray(arr[:, :, ::-1])):
        raise OSError(f"cv2 could not write {path}")


def run_nvs_bench(models: dict, dataset, seq_id_map: dict, scfg,
                  output_dir, *, render_hw=(448, 448), forward_fn=None,
                  pair_budget: int | None = None,
                  device: torch.device | str = "cuda") -> None:
    """Per-sequence gt / pred PNG dump (`nvs_eval.py:156-196`)."""
    for seq_name in dataset.sequence_list:
        if seq_name not in seq_id_map:
            continue
        ids = seq_id_map[seq_name]
        batch = dataset.get_data(sequence_name=seq_name, ids=ids)
        tgt_idx = target_view_indices(ids)
        preds = inference_nvs(models, batch["images"], batch["vae_images"],
                              tgt_idx, scfg, render_hw=render_hw,
                              forward_fn=forward_fn,
                              pair_budget=pair_budget, device=device)
        base = Path(output_dir) / "images" / seq_name
        for i, t in enumerate(tgt_idx):
            save_image(batch["images"][t], base / "gt" / f"{i:0>6}.png")
            save_image(preds[i], base / "pred" / f"{i:0>6}.png")


def _read(path) -> np.ndarray:
    return load_rgb(path).astype(np.float32).transpose(2, 0, 1) / 255.0


def compute_metrics_for_dir(images_dir, *, lpips_model=None,
                            device: torch.device | str = "cuda") -> dict:
    """`calculate_metric.py`: per-image PSNR / SSIM (/ LPIPS with an
    `eval/metrics.py::LPIPSVGG`) over the saved PNGs, computed on
    `device` → per-sequence rows and the overall means."""
    rows = []
    images_dir = Path(images_dir)
    for seq_dir in sorted(p for p in images_dir.iterdir() if p.is_dir()):
        gts, preds = [], []
        for gt_path in sorted((seq_dir / "gt").glob("*.png")):
            gts.append(_read(gt_path))
            preds.append(_read(seq_dir / "pred" / gt_path.name))
        gt = torch.from_numpy(np.stack(gts)).to(device)
        pred = torch.from_numpy(np.stack(preds)).to(device)
        row = {"sequence": seq_dir.name,
               "psnr": float(torch.mean(metrics.compute_psnr(gt, pred))),
               "ssim": float(torch.mean(metrics.compute_ssim(gt, pred)))}
        if lpips_model is not None:
            row["lpips"] = float(torch.mean(
                metrics.compute_lpips(lpips_model, gt, pred)))
        rows.append(row)

    overall = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k != "sequence"}
    return {"per_sequence": rows, "overall": overall}


def write_metric_csvs(result: dict, output_dir) -> None:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = result["per_sequence"]
    with open(out / "per_sequence.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    with open(out / "overall.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(result["overall"].keys()))
        w.writeheader()
        w.writerow(result["overall"])
