"""The port's UniPC sampler against the JAX package's.

The schedule (σ grid, timesteps, order schedule and the precomputed
per-step coefficients) is host float64 math on both sides, rounded to
fp32: it must agree to 1e-7.  The samplers run the same model function on
both sides — a smooth nonlinear map of (x, t), and for CFG of (x, t, text),
written once with numpy-shaped constants in jnp and in torch — from the
same numpy noise, fp32 throughout: the final latents within 1e-5 of their
range (a 10-step chain, each side rounding in its own order; observed
~1e-7), while a wrong coefficient or history slot moves them by ≥ 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.diffusion import unipc as junipc
from vist3a_tpu_torch.diffusion import unipc as tunipc

SHAPE = (1, 4, 2, 3, 3)
TOL = 1e-5


@pytest.fixture(scope="module")
def consts():
    rng = np.random.default_rng(5)
    return {"a": rng.standard_normal(SHAPE).astype(np.float32),
            "w": rng.uniform(0.5, 1.5, SHAPE).astype(np.float32)}


def _model_fns(consts):
    """v(x, t) = w·tanh(x) − a·(1 − t/1000) + 0.1·x·t/1000, in jnp and torch."""
    ja, jw = jnp.asarray(consts["a"]), jnp.asarray(consts["w"])
    ta, tw = torch.from_numpy(consts["a"]), torch.from_numpy(consts["w"])

    def jfn(x, t):
        s = t / 1000.0
        return jw * jnp.tanh(x) - ja * (1 - s) + 0.1 * x * s

    def tfn(x, t):
        s = t / 1000.0
        return tw * torch.tanh(x) - ta * (1 - s) + 0.1 * x * s
    return jfn, tfn


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("steps,shift", [(50, 3.0), (7, 5.0)])
def test_schedule_and_coefficients_match_jax(steps, shift):
    sig_t, ts_t = tunipc.flow_sigmas(steps, shift)
    sig_j, ts_j = junipc.flow_sigmas(steps, shift)
    np.testing.assert_array_equal(sig_t, sig_j)
    np.testing.assert_array_equal(ts_t, ts_j)
    assert tunipc.order_schedule(steps, 2) == junipc.order_schedule(steps, 2)
    cfg_t = tunipc.UniPCConfig(num_steps=steps, shift=shift)
    cfg_j = junipc.UniPCConfig(num_steps=steps, shift=shift)
    got, want = tunipc.precompute_coeffs(cfg_t), junipc.precompute_coeffs(cfg_j)
    assert set(got) == set(want) == set(tunipc.COEFFS)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("steps", [10, 3])
def test_samplers_match_jax(consts, steps):
    jfn, tfn = _model_fns(consts)
    z = np.random.default_rng(steps).standard_normal(SHAPE).astype(np.float32)
    cfg_t = tunipc.UniPCConfig(num_steps=steps)
    cfg_j = junipc.UniPCConfig(num_steps=steps)
    want = junipc.sample(jfn, jnp.asarray(z), cfg_j)
    want_scan = jax.jit(lambda z: junipc.sample_scan(jfn, z, cfg_j))(
        jnp.asarray(z))
    got = tunipc.sample_scan(tfn, torch.from_numpy(z), cfg_t)
    assert got.dtype == torch.float32
    # the port's one sampler against both JAX forms of the chain
    assert _rel(got, want) <= TOL
    assert _rel(got, want_scan) <= TOL
    assert float((got - torch.from_numpy(z)).abs().max()) > 0.1


def test_cfg_model_matches_jax(consts):
    """One guided call, then a whole guided scan, with a text-conditioned
    model on the CFG pair [uncond, cond]."""
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((1, 5, 6)).astype(np.float32)
    uncond = rng.standard_normal((1, 5, 6)).astype(np.float32)
    jfn, tfn = _model_fns(consts)

    def japply(x2, ts, text):
        assert x2.shape[0] == ts.shape[0] == text.shape[0] == 2
        g = text.mean(axis=(1, 2)).reshape(2, 1, 1, 1, 1)
        return jfn(x2, ts.reshape(2, 1, 1, 1, 1)) * (1 + g)

    def tapply(x2, ts, text):
        assert x2.shape[0] == ts.shape[0] == text.shape[0] == 2
        g = text.mean(dim=(1, 2)).reshape(2, 1, 1, 1, 1)
        return tfn(x2, ts.reshape(2, 1, 1, 1, 1)) * (1 + g)

    jm = junipc.cfg_model(japply, jnp.asarray(cond), jnp.asarray(uncond), 5.0)
    tm = tunipc.cfg_model(tapply, torch.from_numpy(cond),
                          torch.from_numpy(uncond), 5.0)
    z = rng.standard_normal(SHAPE).astype(np.float32)
    assert _rel(tm(torch.from_numpy(z), 640.0),
                jm(jnp.asarray(z), 640.0)) <= 1e-6
    cfg_t, cfg_j = tunipc.UniPCConfig(num_steps=6), \
        junipc.UniPCConfig(num_steps=6)
    want = junipc.sample_scan(jm, jnp.asarray(z), cfg_j)
    got = tunipc.sample_scan(tm, torch.from_numpy(z), cfg_t)
    assert _rel(got, want) <= TOL
