"""Per-scene 3DGS post-optimisation.

Port of `vist3a_tpu/train/post_opt.py` (the reference's
`post_opt/simple_trainer.py`, `Runner.train` :804-1030,
`create_splats_with_optimizers` :402-461, `Config` :238-399, and
`post_opt/utils.py:12-49` `CameraOptModule`): the feed-forward Gaussians
refined per scene with Adam through the rasterizer.

  * parametrisation: raw means, log scales, raw quaternions, logit
    opacities, SH split into sh0 / shN (shN at lr/20) (:418-438);
  * the initial prune (opacity ≤ 0.01, :427) is a frozen 0/1 mask
    multiplied into the opacity (the Gaussian count stays fixed);
  * a step: one training view, loss (1 − λ)·L1 + λ·(1 − SSIM) with λ 0.2
    (:941-946), the optional opacity and scale L1 regularisers (:966-977)
    and random background (:925-927);
  * per-group `torch.optim.Adam` (eps 1e-8, optax's): means 1.6e-4 and the
    pose 1e-5 decayed by `ExponentialLR` with γ = 0.01^(1/max_steps),
    stepped after each update, so step t runs at lr·γ^t as optax's
    `exponential_decay(lr, 1, γ)`; scales 5e-3, quats 1e-3, opacities
    5e-2, sh0 2.5e-3, shN 1.25e-4;
  * pose refinement (on by default, :98): a per-view translation and
    6D-rotation delta, zero at the start, right-multiplied onto c2w
    (`utils.py:28-49`).

Each step renders its view through `kernels/rasterizer.py::rasterize`: one
launch of the composite kernel (row 6) forward and one of its backward
(kernel 7).  The loop is a Python loop; the losses stay on the device and
are copied once at the end.  The view (and the background) of step t are
drawn from a CPU generator seeded from (seed, t), as every draw of the
port (the JAX package folds its key: other draws); `views=` and
`backgrounds=` take given draws instead.  The whole step runs with TF32
off (the SSIM convolutions in both directions).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vist3a_tpu_torch.eval.metrics import compute_ssim, full_fp32
from vist3a_tpu_torch.kernels.rasterizer import rasterize
from vist3a_tpu_torch.nn.gaussians import Gaussians, build_covariance
from vist3a_tpu_torch.train.stitching import fold_seed

__all__ = ["PostOptConfig", "refine", "splats_from_gaussians",
           "gaussians_from_splats", "rotation_6d_to_matrix"]

DRAW_VIEW, DRAW_BACKGROUND = 0, 1
ADAM_EPS = 1e-8                  # optax.adam's


@dataclasses.dataclass(frozen=True)
class PostOptConfig:
    """Deployed subset of `post_opt.simple_trainer.Config` (:238-399)."""
    max_steps: int = 3_000
    ssim_lambda: float = 0.2
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_sh: float = 2.5e-3
    lr_pose: float = 1e-5
    pose_opt: bool = True
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    random_bkgd: bool = False
    prune_opacity: float = 0.01
    final_lr_ratio: float = 0.01     # ExponentialLR gamma = ratio**(1/steps)
    pair_budget: int | None = None   # rasterizer tile-pair budget


# --------------------------------------------------------------------------- #
# parametrisation                                                             #
# --------------------------------------------------------------------------- #
def splats_from_gaussians(g: Gaussians, prune_opacity: float = 0.01):
    """Adapter Gaussians (batch 1) → {name: fp32 tensor} trainable splats
    and the live mask (the reference drops low-opacity splats; here their
    opacity is frozen at 0)."""
    means = g.means[0].float()
    scales = torch.log(torch.clamp_min(g.scales[0].float(), 1e-10))
    quats = g.rotations[0].float()
    op = torch.clamp(g.opacities[0].float(), 1e-6, 1.0 - 1e-6)
    opacities = torch.log(op) - torch.log1p(-op)           # logit
    sh = g.harmonics[0].float().transpose(1, 2)            # (G, d_sh, 3)
    splats = {"means": means, "scales": scales, "quats": quats,
              "opacities": opacities, "sh0": sh[:, :1], "shN": sh[:, 1:]}
    live = (g.opacities[0] > prune_opacity).float()
    return splats, live


def gaussians_from_splats(splats: dict, live: torch.Tensor) -> Gaussians:
    """Inverse of `splats_from_gaussians` (batch dim restored)."""
    scales = torch.exp(splats["scales"])
    quats = splats["quats"]
    quats = quats / (torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
                     + 1e-8)
    harmonics = torch.cat([splats["sh0"], splats["shN"]], 1).transpose(1, 2)
    return Gaussians(
        means=splats["means"][None],
        covariances=build_covariance(scales, quats)[None],
        harmonics=harmonics[None],
        opacities=(torch.sigmoid(splats["opacities"]) * live)[None],
        scales=scales[None],
        rotations=quats[None])


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D → rotation matrix, Gram–Schmidt (`utils.py:118-141`)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-12)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 / (torch.linalg.vector_norm(a2, dim=-1, keepdim=True) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def _apply_pose_adjust(c2w: torch.Tensor, delta9: torch.Tensor
                       ) -> torch.Tensor:
    """c2w @ [R(id6 + Δ6) | Δt] (`utils.py:28-49`; a zero delta is the
    identity), batched over leading axes, the product summed elementwise
    in fp32."""
    ident = c2w.new_tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    rot = rotation_6d_to_matrix(delta9[..., 3:] + ident)
    top = torch.cat([rot, delta9[..., :3, None]], -1)          # (..., 3, 4)
    bottom = c2w.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        *top.shape[:-2], 1, 4)
    tf = torch.cat([top, bottom], -2)                          # (..., 4, 4)
    return (c2w[..., :, :, None] * tf[..., None, :, :]).sum(-2)


class RefineResult(NamedTuple):
    gaussians: Gaussians
    c2w_refined: torch.Tensor   # (V, 4, 4)
    losses: torch.Tensor        # (max_steps,), on the host


def _on(x, device: torch.device) -> torch.Tensor:
    """A tensor or an array → an fp32 copy on `device` (an array may be
    read-only, a tensor may come from inference mode, which autograd
    cannot save)."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.array(x, np.float32)).to(device)
    return x.to(device, torch.float32).clone()


def _draw(seed: int, step: int, purpose: int) -> torch.Generator:
    return torch.Generator().manual_seed(fold_seed(seed, step, purpose))


def _optimizers(params: dict, cfg: PostOptConfig):
    """Adam over the decayed groups (means, pose) with its ExponentialLR,
    and Adam over the rest."""
    lrs = {"means": cfg.lr_means, "scales": cfg.lr_scales,
           "quats": cfg.lr_quats, "opacities": cfg.lr_opacities,
           "sh0": cfg.lr_sh, "shN": cfg.lr_sh / 20.0,       # :438
           "pose": cfg.lr_pose}
    decayed = ("means", "pose")

    def adam(names):
        return torch.optim.Adam(
            [{"params": [params[k]], "lr": lrs[k]} for k in names
             if k in params], eps=ADAM_EPS)
    opt_decay = adam(decayed)
    opt_rest = adam([k for k in lrs if k not in decayed])
    gamma = cfg.final_lr_ratio ** (1.0 / cfg.max_steps)
    return (opt_decay, opt_rest), \
        torch.optim.lr_scheduler.ExponentialLR(opt_decay, gamma)


def refine(gaussians: Gaussians, images: torch.Tensor, c2w: torch.Tensor,
           k_norm: torch.Tensor, seed: int = 0,
           cfg: PostOptConfig = PostOptConfig(), *, views=None,
           backgrounds=None, device: torch.device | str = "cuda"
           ) -> RefineResult:
    """Refine batch-1 Gaussians against V posed views, on `device`.

    images (V, H, W, 3) in [0, 1]; c2w (V, 4, 4); k_norm (V, 3, 3)
    width/height-normalised intrinsics (the decoder's convention).
    views (max_steps,) ints and backgrounds (max_steps, 3) replace the
    draws from (seed, step)."""
    device = torch.device(device)
    images, c2w = _on(images, device), _on(c2w, device)
    v, h, w = images.shape[:3]
    splats, live = splats_from_gaussians(
        Gaussians(*(x.to(device) for x in gaussians)), cfg.prune_opacity)
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in splats.items()}
    if cfg.pose_opt:
        params["pose"] = torch.zeros(v, 9, device=device,
                                     requires_grad=True)  # zero_init (:659)
    opts, schedule = _optimizers(params, cfg)
    ks = _on(k_norm, device) * torch.tensor([[w], [h], [1.0]],
                                            device=device)
    n_live = torch.clamp_min(live.sum(), 1.0)
    losses = torch.zeros(cfg.max_steps, device=device)

    def loss_fn(view: int, bg: torch.Tensor) -> torch.Tensor:
        cam = c2w[view]
        if cfg.pose_opt:
            cam = _apply_pose_adjust(cam, params["pose"][view])
        viewmat = torch.linalg.inv(cam)
        g = gaussians_from_splats({k: params[k] for k in splats}, live)
        rgb, _, _ = rasterize(
            g.means[0], g.covariances[0], g.harmonics[0], g.opacities[0],
            viewmat[None], ks[view][None], w, h, background=bg,
            pair_budget=cfg.pair_budget)
        colors, pixels = rgb[0], images[view]              # (H, W, 3), raw
        l1 = torch.mean(torch.abs(colors - pixels))
        ssim = compute_ssim(pixels.permute(2, 0, 1)[None],
                            colors.permute(2, 0, 1)[None])[0]
        loss = l1 * (1.0 - cfg.ssim_lambda) + (1.0 - ssim) * cfg.ssim_lambda
        if cfg.opacity_reg > 0.0:
            loss = loss + cfg.opacity_reg * torch.sum(
                torch.abs(torch.sigmoid(params["opacities"])) * live) / n_live
        if cfg.scale_reg > 0.0:
            loss = loss + cfg.scale_reg * torch.sum(
                torch.abs(torch.exp(params["scales"])) * live[:, None]) \
                / (3 * n_live)
        return loss

    with full_fp32():
        for step in range(cfg.max_steps):
            view = int(views[step]) if views is not None else int(
                torch.randint(0, v, (), generator=_draw(seed, step,
                                                        DRAW_VIEW)))
            if backgrounds is not None:
                bg = _on(backgrounds[step], device)
            elif cfg.random_bkgd:
                bg = torch.rand(3, generator=_draw(seed, step,
                                                   DRAW_BACKGROUND)
                                ).to(device)
            else:
                bg = torch.zeros(3, device=device)
            loss = loss_fn(view, bg)
            for opt in opts:
                opt.zero_grad(set_to_none=True)
            loss.backward()
            for opt in opts:
                opt.step()
            schedule.step()
            losses[step] = loss.detach()

    with torch.no_grad():
        refined = gaussians_from_splats({k: params[k].detach()
                                         for k in splats}, live)
        c2w_out = _apply_pose_adjust(c2w, params["pose"].detach()) \
            if cfg.pose_opt else c2w
    return RefineResult(refined, c2w_out, losses.cpu())
