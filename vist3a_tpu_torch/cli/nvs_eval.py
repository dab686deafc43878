"""Entry point: RE10K novel-view-synthesis evaluation.

Port of `vist3a_tpu/cli/nvs_eval.py` (the reference's
`evaluation/novel_view_synthesis_bench/nvs_eval.py:156-196` and
`calculate_metric.py`): render the target views of each sequence, dump gt
/ pred PNGs, aggregate PSNR / SSIM into CSVs.

    VIST3A_WEIGHTS=/weights python -m vist3a_tpu_torch.cli.nvs_eval \\
        --dataset re10k:/data/re10k --seq_id_map ids.json \\
        --checkpoint_path stitched_model_epoch_0.pth \\
        --stitching_layer_location enc_blocks_16 --lora_config r64,a32 \\
        --resolution 512 --feedforward_resolution 448 --output_dir out

The weights root is `$VIST3A_WEIGHTS` or the attribute
`args.weights_root` (the JAX parser has no flag for it).  The model is the
stitched decoder (trunk bf16) and the Wan VAE's encoder in fp32; the whole
main runs with TF32 off for cuBLAS and cuDNN (the fp32 VAE encode, heads
and metrics as the JAX package computes them in fp32).
"""

from __future__ import annotations

import json

import torch

from vist3a_tpu_torch.cli.arguments import stitching_nvs_evaluation_argument
from vist3a_tpu_torch.eval import nvs
from vist3a_tpu_torch.eval.metrics import full_fp32
from vist3a_tpu_torch.eval.re10k import Re10KNVSDataset


def main(args, *, device: torch.device | str = "cuda") -> tuple[dict, dict]:
    """Load the model, run the bench over `--seq_id_map`, write the PNGs
    and the CSVs under `--output_dir`.  Returns the modules and the
    metrics ({"per_sequence", "overall"})."""
    from vist3a_tpu_torch.cli.model_loading import load_stitched_model

    name, root = args.dataset[0]
    if name != "re10k":
        raise NotImplementedError(f"NVS dataset {name} not implemented")
    with full_fp32():
        modules, scfg = load_stitched_model(args, vae_halves=("encoder",),
                                            device=device)
        dataset = Re10KNVSDataset(
            str(root), split="test", load_img_size=args.resolution,
            feedforward_img_size=args.feedforward_resolution)
        with open(args.seq_id_map) as f:
            seq_id_map = json.load(f)
        # the targets render at the feed-forward size, the gt's (the JAX
        # main renders at 448² whatever that size is)
        size = args.feedforward_resolution
        nvs.run_nvs_bench(modules, dataset, seq_id_map, scfg,
                          args.output_dir, render_hw=(size, size),
                          device=device)
        result = nvs.compute_metrics_for_dir(f"{args.output_dir}/images",
                                             device=device)
    nvs.write_metric_csvs(result, args.output_dir)
    print(result["overall"])
    return modules, result


if __name__ == "__main__":
    main(stitching_nvs_evaluation_argument().parse_args())
