"""Voxel fusion: confidence-softmax scatter aggregation of Gaussians.

Port of `vist3a_tpu/ops/voxel_fusion.py` (the reference's
`src/model/encoder/anysplat.py:298-335`, `voxelizaton_with_fusion`:
torch_scatter's `scatter_max` / `scatter_add` after `torch.unique(dim=0)`):
points quantised to voxel indices, a per-voxel softmax over the
confidences, the confidence-weighted mean of positions and features.  Off
on the deployed path (`voxelize=False`), part of the encoder's surface.

The contract is the JAX package's static-shape one: N output rows, voxel i
in lexicographic (x, y, z) key order, then padding rows flagged by
`valid`.  In torch: a stable sort on the keys (z, then y, then x), segment
ids from the `cumsum` of key changes, `scatter_reduce("amax")` for the
per-voxel maximum and `index_add_` for the sums.
"""

from __future__ import annotations

import torch


def _voxel_coords(pts: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """(N, 3) points → (N, 3) int32 voxel coordinates (round half to even,
    as `jnp.round`)."""
    return torch.round(pts / voxel_size).to(torch.int32)


def voxelize_with_fusion(img_feat: torch.Tensor, pts3d: torch.Tensor,
                         voxel_size: float, conf: torch.Tensor):
    """img_feat (N, C), pts3d (N, 3), conf (N,) →
    (voxel_pts (N, 3), voxel_feats (N, C), valid (N,) bool).

    Row i of the output is voxel i in sorted-key order; rows with
    valid=False are padding (fewer voxels than points)."""
    n = pts3d.shape[0]
    coords = _voxel_coords(pts3d.float(), voxel_size)
    order = torch.arange(n, device=coords.device)
    for col in (2, 1, 0):              # lexsort: the last key sorts first
        order = order[torch.sort(coords[order, col], stable=True).indices]
    coords_s = coords[order]
    pts_s = pts3d[order].float()
    feat_s = img_feat[order].float()
    conf_s = conf[order].float()

    is_new = torch.ones(n, dtype=torch.int64, device=coords.device)
    is_new[1:] = (coords_s[1:] != coords_s[:-1]).any(-1).to(torch.int64)
    seg = torch.cumsum(is_new, 0) - 1                  # (N,) segment ids
    n_voxels = seg[-1] + 1

    conf_max = torch.full((n,), -torch.inf, device=conf_s.device) \
        .scatter_reduce(0, seg, conf_s, "amax")
    conf_exp = torch.exp(conf_s - conf_max[seg])
    denom = torch.zeros(n, device=conf_s.device).index_add_(0, seg, conf_exp)
    w = (conf_exp / (denom[seg] + 1e-6))[:, None]

    voxel_pts = torch.zeros(n, 3, device=pts_s.device).index_add_(
        0, seg, pts_s * w)
    voxel_feats = torch.zeros(n, feat_s.shape[1], device=feat_s.device) \
        .index_add_(0, seg, feat_s * w)
    valid = torch.arange(n, device=seg.device) < n_voxels
    return voxel_pts, voxel_feats, valid
