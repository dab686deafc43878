"""Image quality metrics: PSNR, SSIM and LPIPS-VGG16.

Port of `vist3a_tpu/eval/metrics.py` (the reference's
`src/evaluation/metrics.py:12-52`):

  * PSNR: −10·log10(mean squared error) of [0, 1]-clipped images;
  * SSIM: skimage's `structural_similarity(win_size=11,
    gaussian_weights=True, channel_axis=0, data_range=1.0)` — an 11-tap
    Gaussian window (σ 1.5) applied separably with 'valid' padding, moments
    normalised by the window, C1 = 0.01², C2 = 0.03², the mean over
    channels and pixels.  fp32; the JAX package asks for precision
    HIGHEST, so the convolutions here run with cuDNN's TF32 off;
  * LPIPS(vgg): the five post-ReLU stages of VGG16 on the imagenet-shifted
    input, each unit-normalised across channels (norm floored at 1e-10),
    the squared difference weighted by the 1×1 linear heads, averaged over
    pixels and summed over stages.  `import_lpips_vgg` reads the lpips
    package's `lin{i}.model.1.weight` and torchvision's `features.{i}`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VGG16_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
# torchvision vgg16 `features` indices of the 13 convolutions
VGG16_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


@contextlib.contextmanager
def full_fp32():
    """cuBLAS and cuDNN without TF32 inside the block (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def compute_psnr(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) in [0, 1] → (B,) PSNR."""
    gt = torch.clamp(gt, 0.0, 1.0)
    pred = torch.clamp(pred, 0.0, 1.0)
    mse = torch.mean(torch.square(gt - pred), dim=(1, 2, 3))
    return -10.0 * torch.log10(mse)


def gaussian_window(win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(win_size) - (win_size - 1) / 2.0
    w = np.exp(-(r ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32)


def _filter2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' windowed mean over the last two axes of (N, H, W)."""
    k = w.shape[0]
    x4 = F.conv2d(x[:, None], w.reshape(1, 1, k, 1))
    return F.conv2d(x4, w.reshape(1, 1, 1, k))[:, 0]


def compute_ssim(gt: torch.Tensor, pred: torch.Tensor, *, win_size: int = 11,
                 sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """(B, C, H, W) → (B,), skimage's Gaussian-weighted settings,
    differentiable (the post-optimisation loss)."""
    b, c = gt.shape[:2]
    x = gt.reshape(b * c, *gt.shape[2:]).float()
    y = pred.reshape(b * c, *pred.shape[2:]).float()
    w = torch.from_numpy(gaussian_window(win_size, sigma)).to(x.device)
    with full_fp32():
        ux = _filter2(x, w)
        uy = _filter2(y, w)
        uxx = _filter2(x * x, w)
        uyy = _filter2(y * y, w)
        uxy = _filter2(x * y, w)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return torch.mean(ssim_map.reshape(b, c, *ssim_map.shape[1:]),
                      dim=(1, 2, 3))


# --------------------------------------------------------------------------- #
# LPIPS-VGG                                                                   #
# --------------------------------------------------------------------------- #
class LPIPSVGG(nn.Module):
    """`convs.{stage}.{i}` 3×3 convolutions (OIHW) and `lins.{stage}` the
    per-channel weights of the linear heads — the JAX tree's {convs, lins}."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList()
        c_in = 3
        for c_out, n in VGG16_PLAN:
            stage = nn.ModuleList()
            for _ in range(n):
                stage.append(nn.Conv2d(c_in, c_out, 3, padding=1))
                c_in = c_out
            self.convs.append(stage)
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.zeros(c)) for c, _ in VGG16_PLAN])

    def stages(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(B, 3, H, W) imagenet-scaled → the 5 post-ReLU stage features."""
        feats = []
        for si, stage in enumerate(self.convs):
            for conv in stage:
                x = F.relu(conv(x))
            feats.append(x)
            if si < len(self.convs) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


def lpips_init(generator: torch.Generator,
               device: torch.device | str = "cuda") -> LPIPSVGG:
    """Random LPIPS-VGG weights (tests and checks; real use imports them):
    the JAX package's distributions — N(0, 1/(9·c_in)) kernels, zero
    biases, |N(0, 1)|·0.1 heads — drawn from `generator` (on `device`)."""
    with torch.device(device):
        model = LPIPSVGG()
    with torch.no_grad():
        for stage in model.convs:
            for conv in stage:
                c_in = conv.in_channels
                conv.weight.copy_(torch.randn(
                    conv.weight.shape, generator=generator, device=device)
                    * (9 * c_in) ** -0.5)
                conv.bias.zero_()
        for lin in model.lins:
            lin.copy_(torch.randn(lin.shape, generator=generator,
                                  device=device).abs() * 0.1)
    return model.eval().requires_grad_(False)


def compute_lpips(model: LPIPSVGG, gt: torch.Tensor,
                  pred: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) in [0, 1] → (B,) LPIPS (`normalize=True`: the inputs
    mapped to [−1, 1], then LPIPS' own shift and scale), fp32 with TF32
    off."""
    dev = next(model.parameters()).device
    shift = torch.tensor(LPIPS_SHIFT, device=dev).reshape(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, device=dev).reshape(1, 3, 1, 1)

    def prep(im):
        im = im.to(dev).float() * 2.0 - 1.0
        return (im - shift) / scale

    with full_fp32(), torch.no_grad():
        fx = model.stages(prep(gt))
        fy = model.stages(prep(pred))
        total = 0.0
        for f1, f2, lin in zip(fx, fy, model.lins):
            n1 = f1 / torch.clamp_min(
                torch.linalg.vector_norm(f1, dim=1, keepdim=True), 1e-10)
            n2 = f2 / torch.clamp_min(
                torch.linalg.vector_norm(f2, dim=1, keepdim=True), 1e-10)
            diff = torch.square(n1 - n2)
            w = lin.reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(diff * w, dim=1),
                                       dim=(1, 2))
    return total


def import_lpips_vgg(lpips_sd: dict, vgg_sd: dict, *,
                     device: torch.device | str = "cuda") -> LPIPSVGG:
    """The lpips package's heads (`lin{i}.model.1.weight`, 1×1 convs) and
    torchvision's vgg16 `features.{i}.weight` / `.bias` → `LPIPSVGG`."""
    state, idx = {}, 0
    for s, (_, n) in enumerate(VGG16_PLAN):
        for i in range(n):
            f = VGG16_CONV_INDICES[idx]
            state[f"convs.{s}.{i}.weight"] = torch.as_tensor(
                vgg_sd[f"features.{f}.weight"]).float()
            state[f"convs.{s}.{i}.bias"] = torch.as_tensor(
                vgg_sd[f"features.{f}.bias"]).float()
            idx += 1
        state[f"lins.{s}"] = torch.as_tensor(
            lpips_sd[f"lin{s}.model.1.weight"]).float().reshape(-1)
    with torch.device(device):
        model = LPIPSVGG()
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)
