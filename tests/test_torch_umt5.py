"""The port's UMT5 encoder against the JAX package's.

The tiny config of `tests/test_umt5.py` (vocab 96, d_model 32, 4 heads of
8, d_ff 48, 3 layers); weights from the JAX `init`, carried over by
`convert.load_jax_umt5_params`; token ids and ragged masks from a numpy
seed.

Tolerances: the bucket table is integer and must match exactly; fp32
`encode` within 2e-5 absolute of outputs of magnitude ~1-10 (three layers,
each summing in its own order; a wrong bucket, scale or mask moves them by
O(1)); bf16 within 2⁻⁵ relative to the output's range, as the two
frameworks round the bf16 activations at other places (the tanh GELU runs
in bf16 arithmetic in JAX and in fp32 rounded once here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.nn import umt5 as jumt5
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import umt5 as tumt5

JCFG = jumt5.UMT5Config(vocab_size=96, d_model=32, d_kv=8, num_heads=4,
                        d_ff=48, num_layers=3)
TCFG = tumt5.UMT5Config(vocab_size=96, d_model=32, d_kv=8, num_heads=4,
                        d_ff=48, num_layers=3)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray,
                                  jumt5.init(jax.random.key(0), JCFG))


def _port(params, dtype=torch.float32):
    model = convert.load_jax_umt5_params(tumt5.UMT5Encoder(TCFG), params)
    return model.to(dtype).eval()


@pytest.mark.parametrize("n", [20, 226])
def test_bucket_table_is_the_jax_packages(n):
    np.testing.assert_array_equal(tumt5._bucket_table(n, TCFG),
                                  jumt5._bucket_table(n, JCFG))


@pytest.mark.parametrize("b,n,lengths", [(2, 20, (13, 7)),
                                         (1, 226, (150,))])
def test_encode_matches_jax_fp32(params, rng, b, n, lengths):
    ids = rng.integers(0, JCFG.vocab_size, (b, n))
    mask = np.zeros((b, n), np.int64)
    for i, length in enumerate(lengths):
        mask[i, :length] = 1
    want = np.asarray(jumt5.encode(params, jnp.asarray(ids),
                                   jnp.asarray(mask), JCFG))
    got = tumt5.encode(_port(params), torch.from_numpy(ids),
                       torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (b, n, JCFG.d_model)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # zero past each sequence's length, nonzero before it
    for i, length in enumerate(lengths):
        assert np.all(got[i, length:] == 0)
        assert np.all(np.abs(got[i, :length]).sum(-1) > 0)


def test_encode_matches_jax_bf16(params, rng):
    ids = rng.integers(0, JCFG.vocab_size, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, 9:] = 0
    bf = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                params)
    want = np.asarray(jumt5.encode(bf, jnp.asarray(ids), jnp.asarray(mask),
                                   JCFG), np.float32)
    got = tumt5.encode(_port(params, torch.bfloat16), torch.from_numpy(ids),
                       torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2 ** -5


def test_converter_transposes_the_bare_dense_weights(params):
    sd = convert.from_jax_params({"umt5": params})
    layers = params["layers"]
    for name in tumt5.DENSE:
        np.testing.assert_array_equal(
            sd[f"umt5.layers.1.{name}.weight"].numpy(), layers[name][1].T)
    np.testing.assert_array_equal(sd["umt5.layers.2.rel_bias"].numpy(),
                                  layers["rel_bias"][2])
    np.testing.assert_array_equal(sd["umt5.embed"].numpy(), params["embed"])
    with pytest.raises(KeyError, match="extra"):
        convert.load_jax_umt5_params(tumt5.UMT5Encoder(TCFG),
                                     {**params, "extra": np.zeros(3)})


def test_port_init_has_the_jax_shapes_and_scales(params):
    want = convert.from_jax_params({"umt5": params})
    model = tumt5.init(TCFG, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.bfloat16)
    got = model.state_dict()
    assert {f"umt5.{k}" for k in got} == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[f"umt5.{k}"].shape), k
        assert v.dtype == torch.bfloat16
    w = got["layers.0.wi_0.weight"].float()
    assert abs(w.std().item() * TCFG.d_model ** 0.5 - 1) < 0.1
    assert torch.all(got["final_ln"] == 1)
