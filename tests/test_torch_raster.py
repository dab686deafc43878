"""The port's rasterizer forward against the JAX package's.

Scenes are those of `tests/test_rasterizer.py` (made with numpy from a
seed); JAX runs its Pallas composite in interpret mode, as that file does.
The port runs on CPU tensors, so `composite` takes its plain version
`composite_ref`; the CUDA kernel is held against that plain version on the
card (`tests/test_torch_gpu.py`, `chip_smoke.py`).

Tolerances:
  * projection and SH: fp32 on both sides, rtol 1e-5 (atol 1e-6 for values
    near 0); the integer radius and the validity mask exactly;
  * the pair stream: exactly the same Gaussian ids in the same order within
    every tile, also under a budget that truncates;
  * images: atol 2e-5 on colour and alpha, 2e-4 on depth (values ~4), the
    tolerance of the JAX package's own kernel-vs-naive test — the TPU kernel
    takes T through a log-space prefix sum, the port multiplies in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import make_scene
from vist3a_tpu.kernels import rasterizer as jr
from vist3a_tpu.nn import splat_decoder as jsd
from vist3a_tpu.nn.gaussians import Gaussians as JGaussians
from vist3a_tpu_torch.kernels import rasterizer as tr
from vist3a_tpu_torch.nn import splat_decoder as tsd
from vist3a_tpu_torch.nn.gaussians import Gaussians as TGaussians


def T(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.default_rng(0))


def test_project_gaussians_matches_jax(scene):
    means, covars, _, _, vm, K, W, H, _ = scene
    vm = np.asarray(vm).copy()
    vm[:3, :3] = _rotation(0.3)                    # a rotated camera
    vm[:3, 3] = [0.2, -0.1, 0.5]
    want = jr.project_gaussians(means, covars, jnp.asarray(vm), K, W, H)
    got = tr.project_gaussians(T(means), T(covars), T(vm), T(K), W, H)
    _close(got.mean2d, want.mean2d, 1e-5)
    _close(got.conic, want.conic, 1e-6)
    _close(got.depth, want.depth, 1e-6)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(want.radius))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < means.shape[0]    # some culled


def _rotation(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(rng, degree):
    harm = rng.normal(0, 0.5, (64, 3, 25)).astype(np.float32)
    dirs = rng.normal(0, 2.0, (64, 3)).astype(np.float32)
    want = jr.eval_sh(jnp.asarray(harm), jnp.asarray(dirs), degree)
    got = tr.eval_sh(T(harm), T(dirs), degree)
    _close(got, want, 1e-6)
    assert (np.asarray(want) > 0).any()


def _jax_tile_streams(gid, visits, n_tiles):
    """Per-tile Gaussian-id lists from the JAX stream and its visit list."""
    gid = np.asarray(gid)
    tc = np.asarray(visits.tilechunk)
    meta = np.asarray(visits.meta)
    streams = {t: [] for t in range(n_tiles)}
    for v, m in zip(tc, meta):
        tile, chunk = v >> jr._VC_BITS, v & jr._VC_MASK
        lo, hi = m & 0xFF, (m >> 8) & 0xFF
        if tile < n_tiles:
            streams[tile] += gid[chunk * jr.CHUNK + lo:
                                 chunk * jr.CHUNK + hi].tolist()
    return streams


@pytest.mark.parametrize("budget", [4096, 256])
def test_pair_stream_matches_jax(scene, budget):
    """Same ids, same order, per tile; a budget below the 268 pairs keeps
    the nearest Gaussians' pairs (the JAX stream marks the rest −1)."""
    means, covars, _, op, vm, K, W, H, _ = scene
    ntx, nty = -(-W // 16), -(-H // 16)
    jp = jr.project_gaussians(means, covars, vm, K, W, H)
    jop = jnp.where(jp.valid, op, 0.0)
    gid, visits, _ = jax.jit(jr.build_pairs, static_argnums=(1, 2, 3))(
        jp, ntx, nty, budget, jop >= jr.ALPHA_MIN)
    tp = tr.project_gaussians(T(means), T(covars), T(vm), T(K), W, H)
    top = torch.where(tp.valid, T(op), 0.0)
    pairs = tr.build_pairs(tp, ntx, nty, budget,
                           extra_valid=top >= tr.ALPHA_MIN)
    assert pairs.total == 268
    n = pairs.gid.numel()
    assert n == min(268, budget)
    assert (np.asarray(gid)[n:] == -1).all()
    want = _jax_tile_streams(gid, visits, ntx * nty)
    b = pairs.bounds.tolist()
    assert b[0] == 0 and b[-1] == n
    for t in range(ntx * nty):
        assert pairs.gid[b[t]:b[t + 1]].tolist() == want[t], t


def test_pair_budget_drops_the_deepest_first(scene):
    means, covars, _, op, vm, K, W, H, _ = scene
    tp = tr.project_gaussians(T(means), T(covars), T(vm), T(K), W, H)
    full = tr.build_pairs(tp, 4, 4, 4096)
    cut = tr.build_pairs(tp, 4, 4, 100)
    kept = set(cut.gid.tolist())
    dropped = set(full.gid.tolist()) - kept
    assert dropped and max(tp.depth[list(kept)]) <= min(tp.depth[list(dropped)])


def _rasterize_both(means, covars, harm, op, vms, Ks, W, H, bg):
    want = jr.rasterize(means, covars, harm, op, vms, Ks, W, H,
                        background=bg)
    tr.reset_launch_counts()
    got = tr.rasterize(T(means), T(covars), T(harm), T(op), T(vms), T(Ks),
                       W, H, background=T(bg))
    assert tr.launches == 0            # CPU tensors take the plain version
    return got, want


def _images_close(got, want):
    rgb, dep, alp = got
    assert rgb.shape == tuple(want[0].shape)
    _close(rgb, want[0], 2e-5, 1e-4)
    _close(dep, want[1], 2e-4, 1e-4)
    _close(alp, want[2], 2e-5, 1e-4)


def test_rasterize_matches_jax(scene):
    means, covars, harm, op, vm, K, W, H, bg = scene
    got, want = _rasterize_both(means, covars, harm, op, vm[None], K[None],
                                W, H, bg)
    _images_close(got, want)
    alp = got[2]
    assert alp.max() > 0.5 and alp.min() < 0.2


def test_non_tile_multiple_size_and_several_views(rng):
    means, covars, harm, op, vm, _, _, _, bg = make_scene(rng, g=24)
    w, h = 48, 40
    K = jnp.asarray([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]],
                    jnp.float32)
    vms = jnp.stack([vm, vm.at[0, 3].set(-0.5), vm.at[1, 3].set(0.4)])
    got, want = _rasterize_both(means, covars, harm, op, vms,
                                jnp.stack([K, K, K]), w, h, bg)
    assert got[0].shape == (3, h, w, 3)
    _images_close(got, want)
    assert not torch.allclose(got[0][0], got[0][1])


def test_empty_scene_renders_background(rng):
    means, covars, harm, op, vm, K, W, H, bg = make_scene(rng, g=8)
    got, want = _rasterize_both(means, covars, harm, np.zeros_like(op),
                                vm[None], K[None], W, H, bg)
    _images_close(got, want)
    _close(got[0][0], np.broadcast_to(np.asarray(bg), (H, W, 3)), 1e-7)
    assert float(got[2].abs().max()) == 0.0


def opaque_scene(rng, g=96):
    """Large, nearly opaque splats stacked in depth: most pixels reach the
    T < 1e-4 stop with pairs left behind."""
    means = rng.normal(0, 0.3, (g, 3)).astype(np.float32)
    means[:, 2] += np.linspace(3.0, 6.0, g, dtype=np.float32)
    a = rng.normal(0, 0.5, (g, 3, 3)).astype(np.float32)
    covars = np.einsum("gij,gkj->gik", a, a) + 0.05 * np.eye(3, dtype=np.float32)
    harm = rng.normal(0, 0.3, (g, 3, 25)).astype(np.float32)
    op = rng.uniform(0.9, 0.99, g).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    bg = np.array([0.2, 0.5, 0.1], np.float32)
    return means, covars, harm, op, vm, K, 64, 64, bg


def test_opaque_scene_hits_the_stop(rng):
    means, covars, harm, op, vm, K, W, H, bg = opaque_scene(rng)
    got, want = _rasterize_both(means, covars, harm, op, vm[None], K[None],
                                W, H, bg)
    _images_close(got, want)
    # the stop fired: pixels whose walk ended before their tile's pairs did
    table, pairs = tr.view_pairs(T(means), T(covars), T(harm), T(op), T(vm),
                                 T(K), W, H, tr.default_pair_budget(96))
    img, n_eval, n_comp, n_clamp = tr.composite_ref(
        pairs.gid, pairs.bounds, table, 4, W, H, return_work=True)
    per_tile = (pairs.bounds[1:] - pairs.bounds[:-1]).reshape(4, 4)
    tile_pairs = per_tile.repeat_interleave(16, 0).repeat_interleave(16, 1)
    stopped = n_eval < tile_pairs
    assert stopped.float().mean() > 0.3
    assert (n_comp <= n_eval).all()
    assert (n_clamp <= n_comp).all()
    # a pixel stops at T·(1−α) < 1e-4 with α ≤ 0.999, so T_final < 0.1
    assert float(img[5][stopped].max()) < 0.1


def test_composite_ref_chunks_agree(scene, monkeypatch):
    """The plain version's pair chunks carry T exactly: chunks of 7 pairs
    (many carries) and of 4096 (one) give the same image."""
    means, covars, harm, op, vm, K, W, H, _ = scene
    table, pairs = tr.view_pairs(T(means), T(covars), T(harm), T(op), T(vm),
                                 T(K), W, H, 4096)
    b = tr.composite_ref(pairs.gid, pairs.bounds, table, 4, W, H)
    monkeypatch.setattr(tr, "REF_CHUNK", 7)
    a = tr.composite_ref(pairs.gid, pairs.bounds, table, 4, W, H)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_render_matches_jax(rng):
    means, covars, harm, op, vm, K, W, H, _ = make_scene(rng, g=32)
    g = means.shape[0]
    c2w = np.stack([np.linalg.inv(np.asarray(vm)),
                    np.linalg.inv(np.asarray(vm.at[0, 3].set(-0.3)))])[None]
    k_norm = (np.asarray(K) / np.array([[W], [H], [1.0]], np.float32))
    k_norm = np.stack([k_norm, k_norm])[None].astype(np.float32)
    zeros3 = np.zeros((1, g, 3), np.float32)
    quat = np.tile(np.array([0, 0, 0, 1], np.float32), (1, g, 1))
    jg = JGaussians(means[None], covars[None], harm[None], op[None],
                    zeros3, quat)
    tg = TGaussians(*(T(x) for x in (means[None], covars[None], harm[None],
                                     op[None], zeros3, quat)))
    want = jsd.render(jg, jnp.asarray(c2w), jnp.asarray(k_norm), (H, W))
    got = tsd.render(tg, T(c2w), T(k_norm), (H, W), device="cpu")
    assert got.color.shape == (1, 2, 3, H, W)
    assert float(got.color.min()) >= 0 and float(got.color.max()) <= 1
    _close(got.color, want.color, 2e-5, 1e-4)
    _close(got.depth, want.depth, 2e-4, 1e-4)
    _close(got.alpha, want.alpha, 2e-5, 1e-4)


def test_wrapper_checks_and_devices():
    gid = torch.zeros(4, dtype=torch.int32)
    bounds = torch.zeros(17, dtype=torch.int32)
    table = torch.zeros(8, tr.N_ATTR)
    with pytest.raises(ValueError, match="no composite kernel"):
        tr.composite(gid.to("meta"), bounds.to("meta"), table.to("meta"),
                     4, 64, 64)
    with pytest.raises(TypeError, match="float32"):
        tr._check(gid, bounds, table.double(), 4, 64, 64)
    with pytest.raises(ValueError, match="tile bounds"):
        tr._check(gid, bounds, table, 4, 64, 48)
    with pytest.raises(ValueError, match="contiguous"):
        tr._check(gid, bounds, table.t().contiguous().t(), 4, 64, 64)
    assert tr.default_pair_budget(100) == 1024
    assert tr.default_pair_budget(1000) == 4096
    assert tr.default_pair_budget(1025) == 4096 + 128
