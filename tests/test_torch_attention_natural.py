"""The natural-layout flash-attention forward (head_dim 128) against JAX.

`flash_attention_ref`, the plain version of the port's flash kernel (what
its wrapper runs on CPU tensors), against the JAX package's natural-layout
Pallas kernel `_fwd_kernel` run in interpret mode through
`flash_attention(layout="natural")` and `_flash_fwd`, at head_dim 128 with
ragged sequence lengths (the kernel pads the key tail and masks it).

Tolerances:
  * fp32: 1e-4 absolute on O and LSE — summation order only, at fp32
    rounding (~1e-6 on unit-scale data); a wrong mask, scale or log base
    moves O or LSE by O(1);
  * bf16: the TPU kernel multiplies q by scale·log2(e) in bf16 before the
    product (one more rounding of every logit, ~2⁻⁹ relative) and rounds P
    to bf16 before the PV product, where the plain version keeps both in
    fp32; O is bf16 on both sides (one rounding, 2⁻⁹ relative).  O within
    8e-3 and LSE within 5e-3 absolute on unit-normal inputs with |O| ≤ 0.9
    (observed at most 3.9e-3 and 1.4e-3: one bf16 step of an O above 0.5,
    and the LSE moved by the logit rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.kernels.flash_attention import _flash_fwd, flash_attention
from vist3a_tpu_torch.kernels import flash_attention as fa
from vist3a_tpu_torch.ops.attention import dot_product_attention

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 5e-3)}


def _qkv(rng, b, n_q, n_k, h, d=128):
    return tuple(rng.standard_normal((b, n, h, d)).astype(np.float32)
                 for n in (n_q, n_k, n_k))


def _pallas_natural(q, k, v, dtype, bq=128, bk=128):
    """`_flash_fwd` in interpret mode on (B, N, H, D) inputs → (O, LSE
    (B, H, N)) as fp32 numpy arrays."""
    b, n_q, h, d = q.shape
    n_k = k.shape[1]

    def to_bh(x, n):
        return jnp.asarray(x, dtype).transpose(0, 2, 1, 3).reshape(b * h, n, d)

    o, lse = _flash_fwd(to_bh(q, n_q), to_bh(k, n_k), to_bh(v, n_k),
                        d ** -0.5, bq, bk, True)
    o = np.asarray(o, np.float32).reshape(b, h, n_q, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[..., 0].reshape(b, h, n_q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n_q,n_k,h", [(1, 256, 256, 2),
                                         (2, 200, 333, 3)])
def test_ref_matches_pallas_natural(rng, dtype, b, n_q, n_k, h):
    q, k, v = _qkv(rng, b, n_q, n_k, h)
    o_want, lse_want = _pallas_natural(q, k, v, jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    o, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)))
    assert o.dtype == tdt and lse.dtype == torch.float32
    atol_o, atol_lse = TOL[dtype]
    np.testing.assert_allclose(o.float().numpy(), o_want, atol=atol_o, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=atol_lse, rtol=0)


def test_public_entry_natural_layout_matches_dispatch(rng):
    """`flash_attention(layout="natural")` (D = 128, ragged N) against the
    port's dispatch, which runs the plain math on the CPU."""
    q, k, v = _qkv(rng, 1, 300, 300, 2)
    want = flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                           block_q=128, block_k=128, interpret=True,
                           layout="natural")
    got = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_cpu_natural_wrapper_runs_plain_version_without_counting(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 40, 40, 2))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert (fa.launches_unmasked, fa.launches_masked,
            fa.launches_natural) == (0, 0, 0)
    meta = q.to(torch.bfloat16).to("meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention_fwd(meta, meta, meta)
