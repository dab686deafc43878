"""The port's CUDA kernel on the card (marker `gpu`; skips without one).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest imports JAX.)  Inputs are made on the
card from a seeded generator.
"""

import pytest
import torch

from vist3a_tpu_torch.kernels import flash_attention as fa
from vist3a_tpu_torch.ops.attention import dot_product_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # fp32 matmuls and convolutions in full fp32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,d,n_pad", [
    (2, 1029, 4, 64, 0), (2, 1040, 4, 64, 11), (1, 333, 3, 128, 7),
    (1, 77, 2, 40, 0), (2, 130, 2, 64, 130)])
def test_kernel_matches_ref_on_card(cuda, b, n, h, d, n_pad):
    """bf16 kernel against the fp32 plain version on the same bf16 inputs:
    O within 2e-2 (P is rounded to bf16 before the PV product, O to bf16 on
    store), LSE within 1e-3 (fp32 statistics, summation order only)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, n, h, d, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    kv = (torch.arange(n, device=cuda) < n - n_pad) if n_pad else None
    before = fa.launches_unmasked + fa.launches_masked
    o, lse = fa.flash_attention_fwd(q, k, v, kv)
    torch.cuda.synchronize()
    assert fa.launches_unmasked + fa.launches_masked == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, kv)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_kernel_reads_strided_views_in_place(cuda):
    """q, k, v as views into one (B, N, 3, H, D) tensor, as the attention
    sublayer hands them over."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 1100, 3, 4, 64, generator=gen, device=cuda
                      ).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, _ = fa.flash_attention_fwd(q, k, v)
    o_ref, _ = fa.flash_attention_ref(q, k, v)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_dispatch_raises_instead_of_falling_back(cuda):
    """N ≥ 1024 on the card selects the kernel; fp32 inputs raise there,
    and a short sequence takes the plain math without a launch."""
    x = torch.zeros(1, 1024, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        dot_product_attention(x, x, x)
    before = fa.launches_unmasked + fa.launches_masked
    short = torch.zeros(1, 1023, 2, 64, device=cuda, dtype=torch.bfloat16)
    dot_product_attention(short, short, short)
    assert fa.launches_unmasked + fa.launches_masked == before
