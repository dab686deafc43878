"""The port's Wan DiT against the JAX package's.

Two tiny configs, weights from the JAX `init` carried over by
`convert.load_jax_dit_params`, latents, timesteps and text from a numpy
seed:
  * `tiny`, the `TINY` of `tests/test_wan_dit.py` (dim 48, 4 heads of 12, 2 layers),
    JAX `attn_impl="xla"`: plain attention on both sides;
  * `d128` (dim 256, 2 heads of 128, 2 layers): JAX `attn_impl="pallas"`,
    so the JAX self-attention runs the natural-layout Pallas kernel
    (`_fwd_kernel`) in interpret mode; the port's dispatch runs its plain
    math on the CPU.

Tolerances, relative to the output's largest magnitude:
  * RoPE tables: exact (both round the same float64 angles to fp32);
    `apply_rope` 1e-6 absolute; the timestep embedding 1e-4 absolute (fp32
    sin/cos of arguments up to 10³, where one ulp of the argument is 6e-5);
  * fp32 forward: 1e-4 — two blocks summed in another order (observed
    2.5e-7 and 3.8e-7); a wrong RoPE pairing, gate or layout moves the
    output by O(1);
  * bf16 forward: 2⁻⁶ — both round the activations to bf16 at the same
    points, but the tanh GELU runs in bf16 arithmetic in JAX and in fp32
    rounded once here, matmuls round their sums in another order, and at
    D = 128 the Pallas kernel also rounds q·scale·log2(e) to bf16 (observed
    6.5e-3 and 6.2e-3, about one bf16 step of the output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vist3a_tpu.nn import wan_dit as jdit
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.kernels import flash_attention as fa
from vist3a_tpu_torch.nn import wan_dit as tdit

CFGS = {
    "tiny": dict(dim=48, ffn_dim=96, num_layers=2, num_heads=4, freq_dim=32,
                 text_dim=64),
    "d128": dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2,
                 freq_dim=32, text_dim=64),
}
JAX_IMPL = {"tiny": "xla", "d128": "pallas"}
LATENT = {"tiny": (2, 16, 3, 8, 8), "d128": (2, 16, 3, 16, 16)}


def configs(name):
    return (jdit.WanDiTConfig(**CFGS[name], attn_impl=JAX_IMPL[name]),
            tdit.WanDiTConfig(**CFGS[name]))


@pytest.fixture(scope="module")
def dit_params():
    return {name: jax.tree_util.tree_map(
        np.asarray, jdit.init(jax.random.key(i), configs(name)[0]))
        for i, name in enumerate(CFGS)}


def _port(params, tcfg, dtype=torch.float32):
    model = convert.load_jax_dit_params(tdit.WanDiT(tcfg), params)
    return model.to(dtype).eval()


def _inputs(rng, shape, text_dim):
    latent = rng.standard_normal(shape).astype(np.float32)
    ts = np.array([999.0, 317.5][:shape[0]], np.float32)
    text = rng.standard_normal((shape[0], 7, text_dim)).astype(np.float32)
    return latent, ts, text


def _rel(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("grid", [(3, 4, 5), (4, 32, 32)])
@pytest.mark.parametrize("name", ["tiny", "d128"])
def test_rope_tables_are_the_jax_packages(name, grid):
    jcfg, tcfg = configs(name)
    for got, want in zip(tdit.rope_tables(tcfg, *grid),
                         jdit.rope_tables(jcfg, *grid)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_rope_and_timestep_embedding_match_jax(rng):
    jcfg, tcfg = configs("d128")
    cos, sin = tdit.rope_tables(tcfg, 2, 3, 4)
    x = rng.standard_normal((2, 24, 2, 128)).astype(np.float32)
    want = jdit.apply_rope(jnp.asarray(x), jnp.asarray(cos.numpy()),
                           jnp.asarray(sin.numpy()))
    got = tdit.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # consecutive (even, odd) pairs: rotating the pair (1, 0) of position 1
    # by its angle, not the rotate-half split of `ops/rope.py`
    e0 = torch.zeros(1, 24, 1, 128)
    e0[..., 0] = 1.0
    r = tdit.apply_rope(e0, cos, sin)
    np.testing.assert_allclose(r[0, :, 0, :2].numpy(),
                               torch.stack([cos[:, 0], sin[:, 0]], -1),
                               atol=1e-7)
    t = np.array([0.0, 1.0, 500.0, 999.0, 3.7], np.float32)
    want = jdit.timestep_embedding(jnp.asarray(t), 256)
    got = tdit.timestep_embedding(torch.from_numpy(t), 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("name,dtype,tol", [
    ("tiny", "float32", 1e-4), ("tiny", "bfloat16", 2 ** -6),
    ("d128", "float32", 1e-4), ("d128", "bfloat16", 2 ** -6)])
def test_forward_matches_jax(dit_params, rng, name, dtype, tol):
    jcfg, tcfg = configs(name)
    params = dit_params[name]
    latent, ts, text = _inputs(rng, LATENT[name], jcfg.text_dim)
    jdt = jnp.dtype(dtype)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
    want = jax.jit(lambda p, z, t, c: jdit.forward(p, z, t, c, jcfg,
                                                   remat=False))(
        jp, jnp.asarray(latent, jdt), jnp.asarray(ts), jnp.asarray(text, jdt))
    tdt = getattr(torch, dtype)
    fa.reset_launch_counts()
    got = tdit.forward(_port(params, tcfg, tdt),
                       torch.from_numpy(latent).to(tdt), torch.from_numpy(ts),
                       torch.from_numpy(text).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == LATENT[name]
    assert fa.launches_natural == 0        # the CPU runs the plain math
    assert _rel(got, want) <= tol


def test_converter_reads_the_patch_kernel_channels_last(dit_params):
    params = dit_params["d128"]
    sd = convert.from_jax_params({"dit": params})
    kern = params["patch_embedding"]["kernel"]                # DHWIO
    np.testing.assert_array_equal(sd["dit.patch_embedding.weight"].numpy(),
                                  kern.transpose(4, 3, 0, 1, 2))
    w = params["blocks"]["attn1"]["q"]["w"]
    np.testing.assert_array_equal(sd["dit.blocks.1.attn1.q.weight"].numpy(),
                                  w[1].T)
    np.testing.assert_array_equal(sd["dit.blocks.0.norm2.weight"].numpy(),
                                  params["blocks"]["norm2"]["scale"][0])
    assert "dit.blocks.0.attn2.norm_k" in sd


def test_port_init_has_the_jax_shapes_and_scales(dit_params):
    _, tcfg = configs("d128")
    want = convert.from_jax_params({"dit": dit_params["d128"]})
    model = tdit.init(tcfg, torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.bfloat16)
    got = model.state_dict()
    assert {f"dit.{k}" for k in got} == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[f"dit.{k}"].shape), k
        assert v.dtype == torch.bfloat16
    w = got["blocks.0.ffn.fc1.weight"].float()
    bound = tcfg.dim ** -0.5
    assert bound * 0.95 < w.abs().max().item() <= bound
    assert torch.all(got["blocks.1.attn1.norm_q"] == 1)
