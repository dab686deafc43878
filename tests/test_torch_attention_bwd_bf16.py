"""The bf16 flash-attention backward (kernels 4b and 5) against the JAX VJPs.

On the CPU the backward wrapper runs its plain version,
`flash_attention_bwd_ref`, which computes in fp32 from the bf16 inputs; the
CUDA kernel is held against it on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py`).  The JAX side is the VJP of `flash_attention` in
each layout, run as the JAX package's own tests run it: the transposed
layout at head_dim 64 (`_dq_kernel_t` / `_dkv_kernel_t`, the stitched
decoder's attention) and the natural layout at head_dim 128 (`_dq_kernel` /
`_dkv_kernel`, the Wan DiT's self-attention), Pallas in interpret mode.
Inputs are made with numpy from a seed and handed to both in bf16.

Tolerance, elementwise: |Δ| ≤ 0.05·std(ref) + 2⁻⁶·|ref| for each
gradient.  The JAX kernels round α·q (natural layout: also v·scale) and,
like the port's kernel, P and dS to bf16 before the products and store the
gradients in bf16; the plain version keeps P and dS in fp32 (observed
≤ 0.45 of the limit).  A dropped δ or a skipped tile moves a gradient by
a large share of its largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.kernels.flash_attention import flash_attention as jflash
from vist3a_tpu_torch.kernels import flash_attention as fa

GRAD_ATOL_STD = 0.05
GRAD_RTOL = 2 ** -6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _excess(got: torch.Tensor, want) -> float:
    """max |Δ| / (GRAD_ATOL_STD·std + GRAD_RTOL·|want|): ≤ 1 passes."""
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    got = got.detach().float()
    assert got.shape == want.shape
    limit = GRAD_ATOL_STD * want.std() + GRAD_RTOL * want.abs() + 1e-30
    return float(((got - want).abs() / limit).max())


@pytest.mark.parametrize("layout,shape", [
    ("transposed", (1, 200, 2, 64)),
    ("transposed", (2, 77, 3, 64)),          # N below one 128-row block
    ("natural", (1, 200, 2, 128)),
    ("natural", (1, 333, 2, 128))])          # ragged: 333 = 2·128 + 77
def test_bf16_bwd_matches_jax_pallas_vjp(layout, shape):
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                   for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, layout=layout),
                     q, k, v)
    want = vjp(do)
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(x, np.float32))
                       .to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv)
    before = (fa.launches_backward_bf16, fa.launches_backward_natural)
    got = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    assert (fa.launches_backward_bf16,
            fa.launches_backward_natural) == before   # CPU: the plain path
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _excess(g, w) <= 1.0


def test_bf16_function_gives_gradients_on_cpu():
    """`FlashAttention` on bf16 CPU tensors: the backward runs and gives
    bf16 gradients equal to the plain version's."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 40, 2, 128, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.FlashAttention.apply(*leaves)
    do = torch.randn(o.shape, generator=gen).to(torch.bfloat16)
    o.backward(do)
    o_ref, lse = fa.flash_attention_ref(q, k, v)
    want = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse, do)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0)
