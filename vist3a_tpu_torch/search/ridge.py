"""Stitching-layer search: per-block feature extraction and a streaming
ridge regression.

Port of `vist3a_tpu/search/ridge.py` (the reference's
`find_layer_for_stitching.py`):
  * `extract_block_features` (:159-243): the output of every DINOv2 block
    ("enc_blocks_{i+1}") of ImageNet-normalised images, the 5 prefix tokens
    (cls + 4 registers) stripped, cast to fp16 and moved to the host.  The
    trunk runs on the card (`nn/vit.py::block_taps`; at fp32 its attention
    is the 3×TF32 flash kernel);
  * `fit_conv3d_streaming` (:51-156): XᵀX (d × d, d = C·kT·kH·kW) and XᵀY
    summed over samples of unfolded patches of the trilinear-upsampled
    latent, (XᵀX + λI)W = XᵀY solved in float64, a second pass for the bias
    (the mean residual) and a third for the train MSE;
  * `rank_layers` (:362-373): the argmin-MSE layer is the stitch point.

The fit is the JAX package's host float64 numpy, line for line.  Patches
are REPLICATE-padded to match the deployed conv
(`stitching_layer_builder.py:39`); the reference's unfold zero-pads
(`find_layer_for_stitching.py:36`), so borders differ from it, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from vist3a_tpu_torch.nn import vit as vit_mod
from vist3a_tpu_torch.nn.aggregator import IMAGENET_MEAN, IMAGENET_STD
from vist3a_tpu_torch.nn.heads import _interp_matrix
from vist3a_tpu_torch.stitch.conv_spec import ConvSpec


# --------------------------------------------------------------------------- #
# host-side unfold + ridge solve (float64)                                    #
# --------------------------------------------------------------------------- #
def _as3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def unfold3d(x: np.ndarray, kernel, stride, padding) -> np.ndarray:
    """x: (N, C, T, H, W) → (N, C, kT, kH, kW, To, Ho, Wo), replicate-padded
    sliding blocks (a `np.lib.stride_tricks` view, no im2col copy)."""
    kt, kh, kw = _as3(kernel)
    st, sh, sw = _as3(stride)
    pt, ph, pw = _as3(padding)
    x = np.pad(x, ((0, 0), (0, 0), (pt, pt), (ph, ph), (pw, pw)),
               mode="edge")
    n, c, t, h, w = x.shape
    to = (t - kt) // st + 1
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    sn, sc, s0, s1, s2 = x.strides
    return np.lib.stride_tricks.as_strided(
        x, (n, c, kt, kh, kw, to, ho, wo),
        (sn, sc, s0, s1, s2, s0 * st, s1 * sh, s2 * sw))


def upsample_latent_np(z: np.ndarray, spatial_hw: tuple[int, int]
                       ) -> np.ndarray:
    """Trilinear align_corners=True pre-upsample (host float64), matching
    `models/stitched_model.py:92-107`: T → (T−1)·4+1, spatial to the latent
    grid."""
    t_out = (z.shape[2] - 1) * 4 + 1
    sizes = {2: t_out, 3: spatial_hw[0], 4: spatial_hw[1]}
    out = z.astype(np.float64)
    for axis, n_out in sizes.items():
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        m = _interp_matrix(n_in, n_out).astype(np.float64)
        out = np.moveaxis(np.tensordot(m, np.moveaxis(out, axis, 0),
                                       axes=((1,), (0,))), 0, axis)
    return out


def _patches_matrix(z_b: np.ndarray, spec: ConvSpec, spatial_hw):
    """One sample (C, T, H, W) → design matrix X (rows, d)."""
    z = upsample_latent_np(z_b[None], spatial_hw)
    p = unfold3d(z, spec.kernel_size, spec.stride, spec.padding)
    d = p.shape[1] * p.shape[2] * p.shape[3] * p.shape[4]
    return (p.transpose(0, 5, 6, 7, 1, 2, 3, 4).reshape(-1, d), p.shape[5:])


def _targets_matrix(y_b: np.ndarray) -> np.ndarray:
    """(T, H·W, D) fp16 feature → (T·H·W, D) float64 (the reference
    rearranges 'T (H W) D -> D T H W' then flattens back: the same row
    order)."""
    t, hw, dd = y_b.shape
    return y_b.reshape(t * hw, dd).astype(np.float64)


def fit_conv3d_streaming(spec: ConvSpec, z_batches, y_batches,
                         ridge: float = 1e-4):
    """z_batches: a sequence of (C, T_vae, h, w) latents; y_batches: of
    (T, H·W, D) per-sample features.  Returns ({"kernel" (D, C, kT, kH,
    kW), "bias" (D,)} float32 numpy, train MSE); the solve is float64."""
    spatial_hw = None
    xtx = xty = None
    n_rows = 0
    d_out = None
    for z_b, y_b in zip(z_batches, y_batches):
        z_b = np.asarray(z_b, np.float64)       # (C, T_vae, h, w)
        if spatial_hw is None:
            spatial_hw = (z_b.shape[-2], z_b.shape[-1])
        x_mat, _ = _patches_matrix(z_b, spec, spatial_hw)
        y_mat = _targets_matrix(np.asarray(y_b))
        if xtx is None:
            d = x_mat.shape[1]
            d_out = y_mat.shape[1]
            xtx = np.zeros((d, d))
            xty = np.zeros((d, d_out))
        xtx += x_mat.T @ x_mat
        xty += x_mat.T @ y_mat
        n_rows += x_mat.shape[0]

    xtx[np.diag_indices_from(xtx)] += ridge
    w = np.linalg.solve(xtx, xty)                        # (d, C_out)

    # bias = mean residual (second pass), then train MSE with bias applied
    sum_residual = np.zeros(d_out)
    sq_err = 0.0
    n_vox = 0
    for z_b, y_b in zip(z_batches, y_batches):
        x_mat, _ = _patches_matrix(np.asarray(z_b, np.float64), spec,
                                   spatial_hw)
        y_mat = _targets_matrix(np.asarray(y_b))
        resid = y_mat - x_mat @ w
        sum_residual += resid.sum(0)
    bias = sum_residual / n_rows
    for z_b, y_b in zip(z_batches, y_batches):
        x_mat, _ = _patches_matrix(np.asarray(z_b, np.float64), spec,
                                   spatial_hw)
        y_mat = _targets_matrix(np.asarray(y_b))
        err = y_mat - (x_mat @ w + bias)
        sq_err += float(np.square(err).sum())
        n_vox += err.size

    kt, kh, kw = _as3(spec.kernel_size)
    kernel = w.T.reshape(d_out, -1, kt, kh, kw).astype(np.float32)
    params = {"kernel": kernel, "bias": bias.astype(np.float32)}
    return params, sq_err / n_vox


# --------------------------------------------------------------------------- #
# feature extraction via taps                                                 #
# --------------------------------------------------------------------------- #
@torch.inference_mode()
def extract_block_features(vit: vit_mod.ViT, images01: torch.Tensor,
                           vit_cfg: vit_mod.ViTConfig, *,
                           dtype: torch.dtype = torch.float16
                           ) -> list[torch.Tensor]:
    """images01: (B, S, 3, H, W) in [0, 1] on the trunk's device.  Returns
    the per-block features [(B, S, P, D) in `dtype`] for blocks 1..depth,
    the prefix tokens stripped: the taps standing for the reference's
    forward hooks (`find_layer_for_stitching.py:171-207`)."""
    b, s, c, h, w = images01.shape
    # ImageNet normalisation happens in the aggregator before the patch
    # embedding (`aggregator.py:227-228`): the hooks fire downstream of it
    mean = images01.new_tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1)
    std = images01.new_tensor(IMAGENET_STD).reshape(1, 3, 1, 1)
    imgs = (images01.reshape(b * s, c, h, w) - mean) / std
    n_prefix = 1 + vit_cfg.num_register_tokens
    out = []
    for tap in vit_mod.block_taps(vit, imgs, vit_cfg):
        f = tap[:, n_prefix:, :].to(dtype)
        out.append(f.reshape(b, s, f.shape[1], f.shape[2]))
    return out


def rank_layers(mses: dict[str, float]) -> str:
    """argmin MSE → the best stitching layer's key
    (`find_layer_for_stitching.py:362-373`)."""
    return min(mses, key=mses.get)
