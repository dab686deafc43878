"""The 3×TF32 split of the fp32 flash-attention kernels, on the CPU.

`kernels.flash_attention.tf32_split` is the plain version of the split the
fp32 kernels make of every operand (`csrc/sm90.cuh::tf32_round`): big = x
rounded to TF32, small = x − big rounded the same way.  These tests hold:

  * big: its low 13 mantissa bits are zero, and it is x rounded to the
    nearer of its two TF32 neighbours (ties away from zero);
  * big + small gives x back to 2⁻²¹·|x| across the exponent range; at 0
    and among the subnormals, where TF32's steps are absolute (2⁻¹³⁶ below
    2⁻¹²⁶), to half such a step;
  * the arithmetic the kernels do, emulated in plain torch on the split
    (every product a_big·b_big + a_big·b_small + a_small·b_big, summed in
    fp32), stays within `chip_smoke.py`'s fp32 limits of the plain forward
    and backward at (2, 300, 2, 64), and one TF32 product (no corrections)
    falls outside them: the limits tell the two apart.
Inputs are drawn with numpy from seeds.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vist3a_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(1)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _values(seed: int) -> torch.Tensor:
    """Normals with exponents across fp32's range, 0, ±0 and subnormals."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, 20_000)
    exps = rng.integers(-126, 127, 20_000)
    normals = np.ldexp(mant, exps) * rng.choice([-1.0, 1.0], 20_000)
    sub_bits = rng.integers(1, 1 << 23, 2_000).astype(np.uint32)
    subnormals = sub_bits.view(np.float32).astype(np.float64)
    special = np.array([0.0, -0.0, 2.0 ** -149, 2.0 ** -126, 1.0, -1.0])
    return torch.from_numpy(np.concatenate(
        [normals, subnormals, -subnormals, special]).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_big_is_x_rounded_to_nearest_tf32(seed):
    x = _values(seed)
    big, _ = fa.tf32_split(x)
    assert bool((_bits(big) & 0x1FFF == 0).all())
    # the two TF32 neighbours of x: x truncated, and one TF32 step further
    # from zero (the +0x2000 carries into the exponent where it must)
    lo_bits = _bits(x) & ~0x1FFF
    lo = torch.from_numpy((lo_bits.numpy().astype(np.uint32)).view(np.float32))
    hi = torch.from_numpy(((lo_bits + 0x2000).numpy().astype(np.uint32))
                          .view(np.float32))
    d_lo = (x.double() - lo.double()).abs()
    d_hi = (hi.double() - x.double()).abs()
    want = torch.where(d_hi <= d_lo, hi, lo)     # a tie goes away from zero
    assert torch.equal(_bits(big), _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_big_plus_small_is_x_to_2_pow_minus_21(seed):
    x = _values(seed)
    big, small = fa.tf32_split(x)
    assert bool((_bits(small) & 0x1FFF == 0).all())
    err = (x.double() - big.double() - small.double()).abs()
    limit = torch.maximum(2.0 ** -21 * x.double().abs(),
                          torch.full_like(err, 2.0 ** -137))
    assert bool((err <= limit).all())
    # away from the subnormal range (where small is still normal) the
    # bound is relative alone
    normal = x.double().abs() >= 2.0 ** -115
    assert bool((err[normal] <= 2.0 ** -21 * x.double().abs()[normal]).all())
    zero = x == 0
    assert bool((big[zero] == 0).all() and (small[zero] == 0).all())


def test_rounding_ties_go_away_from_zero():
    one = 1.0 + 2.0 ** -11                      # halfway between TF32 steps
    x = torch.tensor([one, -one, 3.0 * 2.0 ** -11 + 1.0], dtype=torch.float32)
    big, small = fa.tf32_split(x)
    assert big.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                            1.0 + 2.0 ** -9]
    assert torch.equal(big + small, x)


def _product(a, b, corrections: int):
    """a @ b as the kernels compute it: TF32 products of the split, with
    `corrections` of the two correction products (2: 3×TF32, 0: one TF32
    product), summed in fp32."""
    ab, as_ = fa.tf32_split(a)
    bb, bs = fa.tf32_split(b)
    out = ab @ bb
    if corrections >= 1:
        out = out + ab @ bs
    if corrections >= 2:
        out = out + as_ @ bb
    return out


def _emulated(q, k, v, do, corrections: int):
    """The fp32 kernels' forward and backward in plain torch (B, H leading
    → the port's (B, N, H, D) at the end): O, LSE, dQ, dK, dV."""
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    s2 = _product(qh, kh.transpose(-1, -2), corrections) * (scale * math.log2(
        math.e))
    m = s2.amax(-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(-1, keepdim=True)
    o = _product(p, vh, corrections) / l
    lse = (m + torch.log2(l)).squeeze(-1) / math.log2(math.e)
    delta = (doh * o).sum(-1, keepdim=True)
    pr = torch.exp2(s2 - (lse * math.log2(math.e))[..., None])
    dv = _product(pr.transpose(-1, -2), doh, corrections)
    dp = _product(doh, vh.transpose(-1, -2), corrections)
    ds = pr * (dp - delta)
    dq = _product(ds, kh, corrections) * scale
    dk = _product(ds.transpose(-1, -2), qh, corrections) * scale
    return (o.transpose(1, 2), lse, dq.transpose(1, 2), dk.transpose(1, 2),
            dv.transpose(1, 2))


def _errors(q, k, v, do, corrections: int) -> dict:
    o, lse, dq, dk, dv = _emulated(q, k, v, do, corrections)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    refs = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    return {"o": rel(o, o_ref), "lse": (lse - lse_ref).abs().max().item(),
            **{f"d{n}": rel(g, r) for n, g, r in zip("qkv", (dq, dk, dv),
                                                     refs)}}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(8)
    return tuple(torch.from_numpy(rng.standard_normal((2, 300, 2, 64))
                                  .astype(np.float32)) for _ in range(4))


def test_3xtf32_is_within_the_fp32_limits(inputs):
    err = _errors(*inputs, corrections=2)
    assert err["o"] <= cs.F32_O_RTOL, err
    assert err["lse"] <= cs.F32_LSE_ATOL, err
    assert max(err["dq"], err["dk"], err["dv"]) <= cs.F32_GRAD_RTOL, err


def test_one_tf32_product_is_outside_the_fp32_limits(inputs):
    """Single-pass TF32 keeps ~3 digits: the forward's O and LSE and each
    of the three gradients miss their limits."""
    err = _errors(*inputs, corrections=0)
    assert err["o"] > cs.F32_O_RTOL, err
    assert err["lse"] > cs.F32_LSE_ATOL, err
    for g in ("dq", "dk", "dv"):
        assert err[g] > cs.F32_GRAD_RTOL, err
