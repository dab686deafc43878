"""The port's flash-attention backward against autograd and the JAX VJP.

On the CPU the backward wrapper runs its plain version,
`flash_attention_bwd_ref` (the CUDA kernel is held against it on the card,
`test_torch_gpu.py` and `chip_smoke.py`).  The JAX side is the VJP of
`flash_attention(layout="transposed")`, whose backward is the Pallas pair
`_dq_kernel_t` / `_dkv_kernel_t`, in interpret mode as the JAX package's own
tests run it.  Inputs are made with numpy from a seed and handed to both.

Tolerances, relative to each gradient's largest magnitude:
  * fp32: 1e-4 — both sides compute in fp32 and differ in summation order
    only (observed ≤ 1.5e-6); a dropped δ, a wrong scale or a skipped tile
    moves a gradient by O(1);
  * bf16 inputs: 2⁻⁵ — the TPU kernel rounds its folded operands (α·q, and
    P and dS before the products) to bf16 and stores the gradients in bf16,
    while the plain version computes in fp32 from the same bf16 inputs
    (observed ≤ 6.8e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.kernels.flash_attention import flash_attention as jflash
from vist3a_tpu_torch.kernels import flash_attention as fa
from vist3a_tpu_torch.ops.attention import plain_attention


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: under the suite's parallel workers, torch's
    intra-op threads oversubscribe the cores and slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bwd_ref_passes_gradcheck():
    """`FlashAttention` on fp64 CPU tensors (the plain forward and backward
    compute in fp64 there) against finite differences."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 19, 2, 8, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(fa.FlashAttention.apply, (q, k, v),
                                     eps=1e-6, atol=1e-6)


def test_bwd_ref_matches_autograd_of_plain_attention():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((2, 70, 3, 16), 1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    plain_attention(*leaves).backward(do)
    o, lse = fa.flash_attention_ref(q, k, v)
    got = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 200, 2, 64), jnp.float32, 1e-4),
    ((1, 333, 3, 64), jnp.float32, 1e-4),       # ragged: 333 = 2·128 + 77
    ((1, 200, 2, 64), jnp.bfloat16, 2 ** -5)])
def test_bwd_matches_jax_pallas_vjp(shape, dtype, tol):
    q, k, v, do = _inputs(shape, 2)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, layout="transposed"),
                     jq, jk, jv)
    want = vjp(jdo)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                       .to(tdt) for x in (jq, jk, jv, jdo))
    o, lse = fa.flash_attention_fwd(tq, tk, tv)
    got = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        assert _rel(g, w) <= tol


def test_flash_attention_function_on_cpu():
    """The autograd function on CPU tensors: the plain forward, and a
    backward equal to `flash_attention_bwd_ref` (no kernel launched)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((1, 40, 2, 32), 3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.launches_unmasked, fa.launches_backward)
    o = fa.FlashAttention.apply(*leaves)
    assert o.grad_fn is not None
    o.backward(do)
    assert (fa.launches_unmasked, fa.launches_backward) == before
    o_ref, lse = fa.flash_attention_ref(q, k, v)
    torch.testing.assert_close(o.detach(), o_ref, atol=0, rtol=0)
    want = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse, do)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0)


def test_masked_call_has_no_backward():
    """A masked call (the padded inference layout) has no VJP in the JAX
    package: its backward raises rather than dropping the gradient."""
    q = torch.randn(1, 30, 2, 16, requires_grad=True)
    key_valid = torch.arange(30) < 25
    o = fa.FlashAttention.apply(q, q, q, key_valid)
    with pytest.raises(NotImplementedError, match="key_valid"):
        o.sum().backward()
    with torch.inference_mode():           # the inference path is unaffected
        assert fa.flash_attention(q, q, q, key_valid).shape == q.shape
