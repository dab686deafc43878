"""The 14-term distillation loss of stitching training.

Port of `vist3a_tpu/train/losses.py` (the reference's `TaskLossAnySplat`,
`models/anysplat_stitched.py:20-141`): L1 terms aligning the stitched
student with the frozen full-AnySplat teacher, weighted as the reference
weights them (depth gradient ×0.005, scales ×10, confidences ×0.01, anchor
features ×0.1), and the multi-scale gradient loss.  Like the JAX package,
the Gaussian terms compare pixel-corresponding Gaussians (every pixel stays
resident with masked opacity); the covariance term compares the packed
(…, 9) entries, which is the L1 over the 3×3 covariances.
"""

from __future__ import annotations

import torch

from vist3a_tpu_torch.nn.encoder import EncoderOutput
from vist3a_tpu_torch.nn.gaussians import covariance_entries


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def gradient_loss(prediction: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """`models/anysplat_stitched.py:20-37`: differences along axes 2 (x)
    and 1 (y) of an (B, Y, X, ...) tensor, clipped at 100, summed, over
    B·Y·X."""
    diff = prediction.float() - target.float()
    grad_x = (diff[:, :, 1:] - diff[:, :, :-1]).abs().clamp_max(100.0)
    grad_y = (diff[:, 1:, :] - diff[:, :-1, :]).abs().clamp_max(100.0)
    image_loss = grad_x.sum(dim=(1, 2, 3)) + grad_y.sum(dim=(1, 2, 3))
    divisor = prediction.shape[0] * prediction.shape[1] * prediction.shape[2]
    return image_loss.sum() / divisor


def gradient_loss_multi_scale(prediction: torch.Tensor, target: torch.Tensor,
                              scales: int = 4) -> torch.Tensor:
    total = 0.0
    for scale in range(scales):
        step = 2 ** scale
        total = total + gradient_loss(prediction[:, ::step, ::step],
                                      target[:, ::step, ::step])
    return total / scales


def task_loss(student: EncoderOutput,
              teacher: EncoderOutput) -> dict[str, torch.Tensor]:
    """The 14 terms the reference logs, and their sum as "total_loss"."""
    sg, tg = student.gaussians, teacher.gaussians
    loss = {
        "depth_loss": _l1(student.depth, teacher.depth),
        "depth_loss_grad":
            gradient_loss_multi_scale(student.depth, teacher.depth) * 0.005,
        "gaussian_mean_loss": _l1(sg.means, tg.means),
        "gaussian_covariance_loss": _l1(
            covariance_entries(sg.scales, sg.rotations),
            covariance_entries(tg.scales, tg.rotations)),
        "gaussian_harmonics_loss": _l1(sg.harmonics, tg.harmonics),
        "gaussian_opacity_loss": _l1(sg.opacities, tg.opacities),
        "gaussian_scales_loss": _l1(sg.scales, tg.scales) * 10.0,
        "gaussian_rotations_loss": _l1(sg.rotations, tg.rotations),
        "conf_loss": _l1(student.gs_conf, teacher.gs_conf) * 0.01,
        "depth_conf_loss": _l1(student.depth_conf, teacher.depth_conf) * 0.01,
        "anchor_feat_loss":
            _l1(student.anchor_feats, teacher.anchor_feats) * 0.1,
        "context_pose_extrinsic_loss":
            _l1(student.extrinsic_c2w, teacher.extrinsic_c2w),
        "context_pose_intrinsic_loss":
            _l1(student.intrinsic_norm, teacher.intrinsic_norm),
        "pred_pose_enc_list_loss": sum(
            _l1(a, b) for a, b in zip(student.pred_pose_enc_list,
                                      teacher.pred_pose_enc_list)
        ) / len(student.pred_pose_enc_list),
    }
    loss["total_loss"] = sum(loss.values())
    return loss
