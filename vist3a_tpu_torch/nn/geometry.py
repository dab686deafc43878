"""Camera geometry: quaternions, SE3 inverse, pose encodings, unprojection.

Port of `vist3a_tpu/nn/geometry.py` (the parts the decoder runs): scalar-last
(xyzw) quaternions, the 9-d absT_quaR_FoV pose encoding, and batched
depth → world unprojection.  All in fp32; on a card the small matmuls need
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default) to stay
fp32.
"""

from __future__ import annotations

import torch


def quat_to_mat(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """(..., 4) xyzw → (..., 3, 3)."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / ((q * q).sum(-1) + eps)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(*q.shape[:-1], 3, 3)


def closed_form_inverse_se3(se3: torch.Tensor) -> torch.Tensor:
    """(..., 3|4, 4) world→cam [R|t] → (..., 4, 4) cam→world."""
    rt = se3[..., :3, :3].transpose(-1, -2)
    t = se3[..., :3, 3:]
    top = torch.cat([rt, -(rt @ t)], dim=-1)
    bottom = se3.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        *top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor,
                                 image_size_hw: tuple[int, int]):
    """(..., 9) = [T(3), quat_xyzw(4), fov_h, fov_w] → ([R|t] (..., 3, 4),
    K (..., 3, 3))."""
    t = pose_enc[..., :3]
    r = quat_to_mat(pose_enc[..., 3:7])
    extrinsics = torch.cat([r, t[..., None]], dim=-1)
    h, w = image_size_hw
    fy = (h / 2.0) / (torch.tan(pose_enc[..., 7] / 2.0) + 1e-3)
    fx = (w / 2.0) / (torch.tan(pose_enc[..., 8] / 2.0) + 1e-3)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    intrinsics = torch.stack([
        torch.stack([fx, zeros, torch.full_like(fx, w / 2)], -1),
        torch.stack([zeros, fy, torch.full_like(fy, h / 2)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return extrinsics, intrinsics


def unproject_depth(depth: torch.Tensor, extrinsics: torch.Tensor,
                    intrinsics: torch.Tensor) -> torch.Tensor:
    """depth (B,V,H,W[,1]), extrinsics (B,V,3,4) world→cam, intrinsics
    (B,V,3,3) → world points (B,V,H,W,3)."""
    if depth.dim() == 5:
        depth = depth[..., 0]
    _, _, h, w = depth.shape
    fu = intrinsics[..., 0, 0][..., None, None]
    fv = intrinsics[..., 1, 1][..., None, None]
    cu = intrinsics[..., 0, 2][..., None, None]
    cv = intrinsics[..., 1, 2][..., None, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)
    vv = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    cam = torch.stack([(u - cu) * depth / fu, (vv - cv) * depth / fv, depth],
                      dim=-1)
    c2w = closed_form_inverse_se3(extrinsics)
    r, t = c2w[..., :3, :3], c2w[..., :3, 3]
    return torch.einsum("bvij,bvhwj->bvhwi", r, cam) + t[:, :, None, None, :]
