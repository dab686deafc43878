"""The port's flash-attention forward against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version, `flash_attention_ref`;
the Pallas kernels run in interpret mode, as the JAX package's own tests run
them.  Inputs are made with numpy from a seed and handed to both packages.

Tolerances (fp32 on both sides): 1e-4 absolute on O and LSE — the two sides
differ only in summation order and in the TPU kernel's bound-max shift,
both at fp32 rounding (~1e-6 on unit-scale data); 1e-4 leaves room for the
worst row without hiding a wrong mask or a wrong log base (either moves O or
LSE by O(1)).

The tests that launch the CUDA kernel are in `test_torch_gpu.py`.
"""

import ast
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.kernels.flash_attention import (_flash_fwd_t,
                                                flash_attention_masked)
from vist3a_tpu.ops.attention import _xla_attention
from vist3a_tpu_torch.kernels import flash_attention as fa
from vist3a_tpu_torch.ops.attention import dot_product_attention

ATOL = 1e-4
NEG_BIG = -1e30
REPO = Path(__file__).resolve().parent.parent


def _qkv(rng, b, n_q, n_k, h, d, mag=1.0):
    q = (rng.standard_normal((b, n_q, h, d)) * mag).astype(np.float32)
    k = (rng.standard_normal((b, n_k, h, d)) * mag).astype(np.float32)
    v = rng.standard_normal((b, n_k, h, d)).astype(np.float32)
    return q, k, v


def _pallas_t(q, k, v, key_valid=None, bq=128, bk=128):
    """`_flash_fwd_t` in interpret mode on (B, N, H, D) numpy inputs →
    (O (B, N, H, D), LSE (B, H, N))."""
    b, n_q, h, d = q.shape
    n_k = k.shape[1]

    def to_dh(x, n):
        return jnp.asarray(x).transpose(0, 2, 3, 1).reshape(b * h, d, n)

    kv_bias = None
    if key_valid is not None:
        kv_bias = jnp.broadcast_to(
            jnp.where(jnp.asarray(key_valid), 0.0, NEG_BIG)[None, None],
            (b * h, 1, n_k)).astype(jnp.float32)
    ot, lse = _flash_fwd_t(to_dh(q, n_q), to_dh(k, n_k), to_dh(v, n_k),
                           d ** -0.5, bq, bk, True, kv_bias=kv_bias)
    o = np.asarray(ot).reshape(b, h, d, n_q).transpose(0, 3, 1, 2)
    return o, np.asarray(lse).reshape(b, h, n_q)


def _port(q, k, v, key_valid=None):
    kv = None if key_valid is None else torch.from_numpy(key_valid)
    o, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), kv)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("n_q,n_k,d,mask", [
    (256, 256, 64, "none"),      # whole tiles
    (160, 303, 64, "none"),      # ragged: the kernel pads the key tail
    (200, 200, 64, "tail"),      # the padded-token layout: pad keys at the end
    (130, 260, 32, "scatter"),   # masked keys anywhere (global attention)
])
def test_ref_matches_pallas_transposed(rng, n_q, n_k, d, mask):
    q, k, v = _qkv(rng, 2, n_q, n_k, 3, d)
    kv = None
    if mask == "tail":
        kv = np.arange(n_k) < n_k - 11
    elif mask == "scatter":
        kv = rng.random(n_k) > 0.3
    o_ref, lse_ref = _pallas_t(q, k, v, kv)
    o, lse = _port(q, k, v, kv)
    np.testing.assert_allclose(o, o_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, lse_ref, atol=ATOL, rtol=0)


def test_ref_lse_is_natural_log(rng):
    """LSE = ln Σ_j exp(scale·q·k_j) over live keys, not the base-2 value."""
    q, k, v = _qkv(rng, 1, 64, 96, 2, 64)
    kv = np.arange(96) < 80
    _, lse = _port(q, k, v, kv)
    s = np.einsum("bnhd,bmhd->bhnm", q.astype(np.float64),
                  k.astype(np.float64))[..., :80] / 8.0
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse, want, atol=ATOL, rtol=0)


def test_ref_fully_masked_rows_are_zero(rng):
    """Every key masked: O = 0 and not NaN, on both sides (`safe_l`).  The
    LSE of such a row has no meaning; the port writes the finite sentinel
    −1e30·ln 2, the TPU kernel its per-row shift bound — both finite."""
    q, k, v = _qkv(rng, 1, 150, 150, 2, 64)
    kv = np.zeros(150, bool)
    o_ref, lse_ref = _pallas_t(q, k, v, kv)
    o, lse = _port(q, k, v, kv)
    assert np.all(o == 0) and np.all(o_ref == 0)
    assert np.isfinite(lse_ref).all()
    np.testing.assert_array_equal(lse, np.float32(NEG_BIG / math.log2(math.e)))


@pytest.mark.parametrize("mag", [1e-3, 30.0])
def test_ref_extreme_magnitudes(rng, mag):
    """Tiny and hot logits (near-one-hot rows) with a zero query row: the
    port's running-max form and the TPU kernel's bound shift agree.  At
    mag 30 the logits reach ~10³, where one fp32 rounding of a logit
    (~6e-5) already moves a softmax weight by that relative amount, so O is
    held to ATOL·mag there."""
    q, k, v = _qkv(rng, 1, 160, 303, 2, 64, mag=mag)
    q[0, 0] = 0.0
    o_ref, lse_ref = _pallas_t(q, k, v)
    o, lse = _port(q, k, v)
    np.testing.assert_allclose(o, o_ref, atol=ATOL * max(1.0, mag), rtol=0)
    np.testing.assert_allclose(lse, lse_ref, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("n,n_pad", [(272, 16), (1040, 11)])
def test_masked_entry_matches_port(rng, n, n_pad):
    """`flash_attention_masked` (interpret) against the port's masked path
    through its attention dispatch — at a small shape and at the frame
    attention's N = 1040 with its 11 pad keys."""
    q, k, v = _qkv(rng, 1, n, n, 2, 64)
    kv = np.arange(n) < n - n_pad
    want = flash_attention_masked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(kv),
                                  block_q=256, block_k=256, interpret=True)
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                key_valid=torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    o, _ = _port(q, k, v, kv)
    np.testing.assert_allclose(o, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_xla(rng, dtype):
    """The short-sequence path (`_xla_attention`), with a key mask; bf16
    compares at the bf16 rounding of the output (2⁻⁷ relative)."""
    q, k, v = _qkv(rng, 2, 40, 40, 2, 32)
    kv = np.arange(40) < 33
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = _xla_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                          key_valid=jnp.asarray(kv))
    got = dot_product_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        key_valid=torch.from_numpy(kv))
    tol = ATOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_wrapper_checks_what_the_kernel_takes():
    """The CUDA wrapper's checks run before any launch; they raise on what
    the kernel does not take (fp32, head_dim, shapes, strides)."""
    bf = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        fa._check(bf.float(), bf, bf, None)
    d72 = torch.zeros(1, 16, 2, 136, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check(d72, d72, d72, None)
    with pytest.raises(ValueError, match="do not match"):
        fa._check(bf, bf[:, :, :1], bf[:, :, :1], None)
    with pytest.raises(ValueError, match="strides"):
        odd = torch.zeros(1, 16, 2, 65, dtype=torch.bfloat16)[..., :64]
        fa._check(odd, odd, odd, None)
    with pytest.raises(ValueError, match="key_valid"):
        fa._check(bf, bf, bf, torch.ones(15, dtype=torch.bool))
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention_fwd(bf.to("meta"), bf.to("meta"), bf.to("meta"))


def test_cpu_wrapper_runs_plain_version_without_counting(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 32, 32, 2, 16))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert (fa.launches_unmasked, fa.launches_masked) == (0, 0)


def _imports(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(p for p in (REPO / "vist3a_tpu_torch").rglob("*.py")
                   if "_build" not in p.parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
            assert root != "vist3a_tpu", (path, mod)
    # and a fresh interpreter that imports every module loads no JAX
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in files if p.parent != REPO]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'vist3a_tpu')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
