"""The composite backward (kernel 7) and the differentiable rasterizer
against autograd and the JAX package's VJP.

On the CPU, `Composite.backward` runs the explicit plain version
`composite_bwd_ref`, then `pair_rows_to_gaussians`; the CUDA kernel is
held against the plain version on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py`).  Scenes are those of `tests/test_rasterizer.py` (numpy
from a seed); JAX runs its Pallas composite and its VJP (`_bwd_kernel`) in
interpret mode, as that file does.

Tolerances:
  * `Composite` against autograd through `composite_ref`, per table
    column, 1e-5 of the column's largest gradient (fp32 on both sides; the
    explicit backward forms the suffix as total − prefix, autograd through
    the cumprod; observed ≤ 4.0e-7);
  * `rasterize` gradients against the JAX VJP: 1e-4 of each input's
    largest gradient (the TPU kernel takes T through a log-space prefix
    sum, and its per-Gaussian sums as an fp32 prefix difference; observed
    ≤ 1.6e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import make_scene
from vist3a_tpu.kernels import rasterizer as jr
from vist3a_tpu_torch.kernels import rasterizer as tr


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.default_rng(0))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _table_and_pairs(scene, budget=4096):
    means, covars, harm, op, vm, K, W, H, _ = scene
    table, pairs = tr.view_pairs(T(means), T(covars), T(harm), T(op),
                                 T(vm).float(), T(K).float(), W, H, budget)
    return table.detach(), pairs, -(-W // tr.TILE), W, H


@pytest.mark.parametrize("budget", [4096, 150])
def test_composite_backward_matches_autograd(scene, budget):
    """The explicit backward against autograd through the plain forward,
    also with a budget that cuts the stream."""
    table, pairs, ntx, W, H = _table_and_pairs(scene, budget)
    gout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, H, W)).astype(np.float32))
    a = table.clone().requires_grad_()
    out = tr.Composite.apply(a, pairs.gid, pairs.bounds, ntx, W, H)
    assert out.grad_fn is not None
    (out * gout).sum().backward()
    b = table.clone().requires_grad_()
    (tr.composite_ref(pairs.gid, pairs.bounds, b, ntx, W, H)
     * gout).sum().backward()
    scale = b.grad.abs().amax(0).clamp_min(1e-30)
    assert float(((a.grad - b.grad).abs().amax(0) / scale).max()) <= 1e-5
    assert float(b.grad[:, 0].abs().max()) > 0     # means get a gradient


def test_composite_backward_zero_beyond_the_clamp():
    """A splat whose a_raw ≥ 0.999 over the whole tile (opacity 1, a
    nearly flat conic) gets no gradient through α — geometry and opacity —
    only through its colour and depth; at opacity 0.9 it gets both."""
    gid = torch.zeros(1, dtype=torch.int32)
    bounds = torch.tensor([0, 1], dtype=torch.int32)
    gout = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (6, 16, 16)).astype(np.float32))
    for opacity, clamped in ((1.0, True), (0.9, False)):
        table = torch.tensor([[8.0, 8.0, 1e-6, 0.0, 1e-6, opacity, 0.2, 0.3,
                               0.4, 2.0]])
        out = tr.composite(gid, bounds, table, 1, 16, 16)
        d = tr.composite_bwd_ref(gid, bounds, table, out, gout, 1, 16, 16)
        assert float(d[0, 6:].abs().min()) > 0
        assert (float(d[0, :6].abs().max()) == 0) == clamped


def test_pair_rows_to_gaussians_matches_index_add():
    rng = np.random.default_rng(3)
    gid = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
    rows = torch.from_numpy(rng.standard_normal((400, 10)).astype(np.float32))
    want = torch.zeros(60, 10, dtype=torch.float64).index_add_(
        0, gid.long(), rows.double())
    got = tr.pair_rows_to_gaussians(rows, gid, 60)
    assert got.shape == (60, 10) and got.dtype == torch.float32
    torch.testing.assert_close(got, want.float(), atol=1e-6, rtol=1e-6)
    assert float(got[50:].abs().max()) == 0.0


@pytest.mark.parametrize("budget", [None, 150])
def test_rasterize_gradients_match_jax_vjp(scene, budget):
    """Gradients of a random cotangent through two views (one rotated),
    with and without per-view recompute, against the JAX VJP."""
    means, covars, harm, op, vm, K, W, H, bg = scene
    vm2 = np.asarray(vm).copy()
    vm2[0, 3] += 0.3
    vms, Ks = jnp.stack([vm, jnp.asarray(vm2)]), jnp.stack([K, K])
    rng = np.random.default_rng(2)
    cot = [rng.standard_normal(s).astype(np.float32)
           for s in ((2, H, W, 3), (2, H, W), (2, H, W))]

    def jloss(m, c, h, o):
        out = jr.rasterize(m, c, h, o, vms, Ks, W, H, background=bg,
                           pair_budget=budget)
        return sum(jnp.sum(a * b) for a, b in zip(out, cot))
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(means, covars, harm, op)
    for remat in (False, True):
        leaves = [T(x).requires_grad_() for x in (means, covars, harm, op)]
        tr.reset_launch_counts()
        out = tr.rasterize(*leaves, T(vms), T(Ks), W, H, background=T(bg),
                           pair_budget=budget, remat_views=remat)
        assert all(x.grad_fn is not None for x in out)
        loss = sum((a * T(b)).sum() for a, b in zip(out, cot))
        got = torch.autograd.grad(loss, leaves)
        assert (tr.launches, tr.launches_backward) == (0, 0)   # CPU path
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-4
