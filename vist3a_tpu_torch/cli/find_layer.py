"""Entry point: the stitching-layer search.

Port of `vist3a_tpu/cli/find_layer.py` (the reference's
`find_layer_for_stitching.py:246-373`): the per-block features of the
AnySplat trunk and the Wan VAE latents of `--iterations_for_feature_
extraction` batches (cached in `features.npz`), a ridge conv3d fitted per
candidate block, `state_dict_enc_blocks_k.npz` ({kernel, bias}, the JAX
package's artifact) and `mse_enc_blocks_k.txt` per layer (each skipped when
both exist), and the argmin-MSE block printed as the recommendation:

    VIST3A_WEIGHTS=ROOT python -m vist3a_tpu_torch.cli.find_layer \\
        --dataset dl3dv:/data/dl3dv --feature_save_path features \\
        --iterations_for_feature_extraction 100

(`--weights_root` is not a flag of this parser, as in the JAX package:
$VIST3A_WEIGHTS or the attribute `args.weights_root`.)  The trunk and
the VAE run on the card; the fit
is host float64 numpy (`search/ridge.py`).  The posterior sample of step i
is a torch draw from a generator seeded from (seed, i), other numbers than
the JAX `fold_in(key, i)`: `run` takes them as `posterior_eps` where a test
feeds both packages the same.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vist3a_tpu_torch.cli.arguments import find_layer_stitching_argument
from vist3a_tpu_torch.io import checkpoints as ckpt
from vist3a_tpu_torch.nn import wan_vae
from vist3a_tpu_torch.search import ridge
from vist3a_tpu_torch.train.stitching import fold_seed


def run(vit, vae: wan_vae.WanVAEEncoder, vit_cfg, conv_spec, loader, *,
        feature_save_path, iterations: int, seed: int = 0,
        ridge_lambda: float = 1e-4, posterior_eps=None):
    """The search over the first `iterations` batches of `loader`
    ({"vae_image_tensor", "feedforward_image_tensor"}, each (B, 3, T, H, W)
    in [−1, 1]), the trunk `vit` (a `ViT`) and `vae` on one device.
    posterior_eps: optional per-step noise of the posterior sample (the
    latent's shape), else drawn from (seed, step).  Returns
    (best_layer_name, {layer: mse})."""
    save = Path(feature_save_path)
    save.mkdir(parents=True, exist_ok=True)
    feat_file = save / "features.npz"
    device = vit.cls_token.device

    if feat_file.exists():
        cached = ckpt.load_search_artifact(feat_file)
        vae_feats = cached.pop("vae_features")
        ff_feats = {k: v for k, v in cached.items()
                    if k.startswith("enc_blocks_")}
    else:
        vae_list, ff_lists = [], {}
        for step, batch in enumerate(loader):
            if step >= iterations:
                break
            vae_pm1 = torch.as_tensor(batch["vae_image_tensor"]).to(device)
            ff_pm1 = torch.as_tensor(
                batch["feedforward_image_tensor"]).to(device)
            with torch.no_grad():
                mu, logvar = wan_vae.encode(vae, vae_pm1)
                if posterior_eps is None:
                    gen = torch.Generator(device=device).manual_seed(
                        fold_seed(seed, step))
                    z = wan_vae.sample_posterior(mu, logvar, gen)
                else:
                    eps = torch.tensor(np.asarray(posterior_eps[step]))
                    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
                    z = mu + std * eps.to(device)
            vae_list.append(z.float().cpu().numpy().astype(np.float16))
            images01 = ((ff_pm1 + 1.0) * 0.5).transpose(1, 2)
            feats = ridge.extract_block_features(vit, images01, vit_cfg)
            for i, f in enumerate(feats):
                ff_lists.setdefault(f"enc_blocks_{i + 1}", []).append(
                    f.cpu().numpy())
            del feats
        vae_feats = np.concatenate(vae_list, axis=0)
        ff_feats = {k: np.concatenate(v, axis=0) for k, v in ff_lists.items()}
        ckpt.save_search_artifact(feat_file,
                                  {"vae_features": vae_feats, **ff_feats})

    mses = {}
    for layer_key, feats in sorted(ff_feats.items()):
        sd_file = save / f"state_dict_{layer_key}.npz"
        mse_file = save / f"mse_{layer_key}.txt"
        if mse_file.exists() and sd_file.exists():
            mses[layer_key] = float(mse_file.read_text().strip())
            continue
        # (N, S, P, D) features → per-sample (S, P, D) targets; (N, C, T,
        # h, w) latents → per-sample (C, T, h, w)
        z_batches = [vae_feats[i].astype(np.float64)
                     for i in range(vae_feats.shape[0])]
        y_batches = [feats[i].astype(np.float64)
                     for i in range(feats.shape[0])]
        params, mse = ridge.fit_conv3d_streaming(conv_spec, z_batches,
                                                 y_batches,
                                                 ridge=ridge_lambda)
        ckpt.save_search_artifact(sd_file, params)
        mse_file.write_text(f"{mse}\n")
        mses[layer_key] = mse

    best = ridge.rank_layers(mses)
    print(f"Best stitching layer: {best} with MSE: {mses[best]}")
    return best, mses


def main(args, *, device: torch.device | str = "cuda"):
    """The command line: the AnySplat encoder's trunk and the Wan VAE
    encoder from the weights root, the datasets without augmentation, then
    `run`.  Returns `run`'s (best layer, {layer: mse})."""
    from vist3a_tpu_torch.cli import model_loading as ml
    from vist3a_tpu_torch.data.loader import create_stitching_dataloader

    root = ml.weights_root(args)
    ecfg = ml.EncoderConfig()
    encoder = ml.load_anysplat_encoder(root, ecfg, device=device)
    vae = ml.load_wan_vae(root, ml.WanVAEConfig(), halves=("encoder",),
                          device=device)["encoder"]
    loader, _ = create_stitching_dataloader(
        [(n, str(p)) for n, p in args.dataset], args, augmentation=False)
    return run(encoder.vit, vae, ecfg.vit, args.stitching_layer_config,
               loader, feature_save_path=args.feature_save_path,
               iterations=args.iterations_for_feature_extraction)


if __name__ == "__main__":
    main(find_layer_stitching_argument().parse_args())
