"""Per-scene post-optimisation of the port (`train/post_opt.py`) against
the JAX package's, on the CPU (the rasterizer's plain versions; JAX runs
its Pallas kernels in interpret mode).

The scene is `tests/test_post_opt.py`'s: 48 Gaussians, three cameras 0.4
apart, 32² views, pair budget 4096.

  * the parametrisation round trip, the prune mask, the 6D identity and
    the pose adjust: against JAX to fp32 rounding (1e-6 absolute on unit
    quantities, 1e-5 relative on the covariances);
  * `refine` for 4 steps (pose refinement, random background and both
    regularisers on) with JAX's view and background draws handed in
    (`views=`, `backgrounds=`): the per-step losses within 1e-5 relative
    and every refined parameter within 1e-3 of its group's Adam step
    (lr·steps): Adam's first moves are ≈ lr·sign(g), so a gradient at the
    noise floor may move its parameter by up to lr a step in either
    package, while a wrong gradient, lr or bias correction moves
    parameters by O(lr) everywhere; the refined cameras within 1e-3 of
    how far JAX's moved;
  * the perturbed-scene recovery of the JAX test, at 30 steps: the loss
    falls and the photometric error to the clean renders shrinks;
  * the draws: step t's view comes from (seed, t), the same on every call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_post_opt import scene  # noqa: F401  (the JAX test's fixture)
from vist3a_tpu.kernels.rasterizer import rasterize as jrasterize
from vist3a_tpu.train import post_opt as jpo
from vist3a_tpu_torch.kernels import rasterizer as tr
from vist3a_tpu_torch.nn.gaussians import Gaussians
from vist3a_tpu_torch.train import post_opt as tpo

STEPS = 4
LOSS_RTOL = 1e-5
PARAM_ADAM_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_gaussians(g) -> Gaussians:
    return Gaussians(*(torch.from_numpy(np.array(x)) for x in g))


def _target(gaussians, c2w, k_norm, hw):
    """Clean renders of the scene (the port's plain rasterizer)."""
    h, w = hw
    ks = torch.from_numpy(np.array(k_norm)) \
        * torch.tensor([[w], [h], [1.0]])
    viewmats = torch.linalg.inv(torch.from_numpy(np.array(c2w)))
    g = gaussians
    rgb, _, _ = tr.rasterize(g.means[0], g.covariances[0], g.harmonics[0],
                             g.opacities[0], viewmats, ks, w, h,
                             pair_budget=4096)
    return torch.clamp(rgb, 0.0, 1.0)


def test_splats_round_trip_matches_jax(scene):  # noqa: F811
    gaussians, *_ = scene
    g2 = gaussians._replace(opacities=gaussians.opacities.at[0, 0].set(0.001))
    js, jlive = jpo.splats_from_gaussians(g2)
    ts, tlive = tpo.splats_from_gaussians(_torch_gaussians(g2))
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
    assert float(tlive[0]) == 0.0
    for k, v in js.items():
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    jb = jpo.gaussians_from_splats(js, jlive)
    tb = tpo.gaussians_from_splats(ts, tlive)
    for name, a, b in zip(jb._fields, tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert float(tb.opacities[0, 0]) == 0.0


def test_rotation_6d_and_pose_adjust_match_jax():
    ident = np.array([1.0, 0, 0, 0, 1.0, 0], np.float32)
    np.testing.assert_allclose(
        tpo.rotation_6d_to_matrix(torch.from_numpy(ident)).numpy(),
        np.eye(3), atol=1e-6)
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3] = 0.7
    np.testing.assert_allclose(tpo._apply_pose_adjust(
        torch.from_numpy(c2w), torch.zeros(9)).numpy(), c2w, atol=1e-6)
    rng = np.random.default_rng(5)
    cams = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    cams[:, :3, :3] = np.linalg.qr(rng.standard_normal((3, 3, 3)))[0]
    cams[:, :3, 3] = rng.standard_normal((3, 3))
    delta = (rng.standard_normal((3, 9)) * 0.2).astype(np.float32)
    want = np.asarray(jax.vmap(jpo._apply_pose_adjust)(jnp.asarray(cams),
                                                       jnp.asarray(delta)))
    got = tpo._apply_pose_adjust(torch.from_numpy(cams),
                                 torch.from_numpy(delta)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _jax_draws(key, steps: int, v: int):
    """The views and backgrounds JAX's `refine` draws at each step."""
    views, bgs = [], []
    for s in range(steps):
        k = jax.random.fold_in(key, s)
        views.append(int(jax.random.randint(jax.random.fold_in(k, 0), (), 0,
                                            v)))
        bgs.append(np.asarray(jax.random.uniform(jax.random.fold_in(k, 1),
                                                 (3,))))
    return views, np.stack(bgs)


def test_refine_matches_jax(scene):  # noqa: F811
    gaussians, c2w, k_norm, hw = scene
    h, w = hw
    ks = k_norm * jnp.asarray([[w], [h], [1.0]], jnp.float32)[None]
    rgb, _, _ = jrasterize(
        gaussians.means[0], gaussians.covariances[0], gaussians.harmonics[0],
        gaussians.opacities[0], jnp.linalg.inv(c2w), ks, w, h,
        pair_budget=4096)
    target = jnp.clip(rgb, 0.0, 1.0)
    rng = np.random.default_rng(3)
    start = gaussians._replace(
        means=gaussians.means + jnp.asarray(
            rng.normal(0, 0.05, gaussians.means.shape), jnp.float32),
        harmonics=gaussians.harmonics + jnp.asarray(
            rng.normal(0, 0.15, gaussians.harmonics.shape), jnp.float32))
    cfg = jpo.PostOptConfig(max_steps=STEPS, pose_opt=True, lr_pose=1e-3,
                            opacity_reg=0.01, scale_reg=0.01,
                            random_bkgd=True, pair_budget=4096)
    key = jax.random.key(2)
    want = jpo.refine(start, target, c2w, k_norm, key, cfg)
    views, bgs = _jax_draws(key, STEPS, c2w.shape[0])

    got = tpo.refine(_torch_gaussians(start), np.asarray(target),
                     np.asarray(c2w), np.asarray(k_norm), 0,
                     tpo.PostOptConfig(**dataclasses.asdict(cfg)),
                     views=views, backgrounds=bgs, device="cpu")
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=LOSS_RTOL)

    js, _ = jpo.splats_from_gaussians(want.gaussians)
    ts, _ = tpo.splats_from_gaussians(got.gaussians)
    lr = {"means": cfg.lr_means, "scales": cfg.lr_scales,
          "quats": cfg.lr_quats, "opacities": cfg.lr_opacities,
          "sh0": cfg.lr_sh, "shN": cfg.lr_sh / 20}
    for k, v in js.items():
        # the refined splats read back through the parametrisation; quats
        # come back normalised
        err = np.abs(ts[k].numpy() - np.asarray(v)).max()
        assert err <= PARAM_ADAM_SHARE * lr[k] * STEPS + 1e-6, (k, err)
    pose_err = np.abs(got.c2w_refined.numpy()
                      - np.asarray(want.c2w_refined)).max()
    moved = np.abs(np.asarray(want.c2w_refined) - np.asarray(c2w)).max()
    assert moved > 1e-4 and pose_err <= PARAM_ADAM_SHARE * moved, \
        (moved, pose_err)


def test_refine_recovers_perturbed_scene(scene):  # noqa: F811
    gaussians, c2w, k_norm, hw = scene
    clean = _torch_gaussians(gaussians)
    target = _target(clean, c2w, k_norm, hw)
    rng = np.random.default_rng(3)
    perturbed = clean._replace(
        means=clean.means + torch.from_numpy(
            rng.normal(0, 0.05, clean.means.shape).astype(np.float32)),
        harmonics=clean.harmonics + torch.from_numpy(
            rng.normal(0, 0.15, clean.harmonics.shape).astype(np.float32)))
    err0 = float(torch.mean(torch.abs(
        _target(perturbed, c2w, k_norm, hw) - target)))
    cfg = tpo.PostOptConfig(max_steps=30, pose_opt=False, opacity_reg=0.001,
                            scale_reg=0.001, pair_budget=4096)
    tr.reset_launch_counts()
    result = tpo.refine(perturbed, target, np.asarray(c2w),
                        np.asarray(k_norm), 0, cfg, device="cpu")
    assert (tr.launches, tr.launches_backward) == (0, 0)   # plain on the CPU
    assert result.losses.shape == (30,)
    assert torch.isfinite(result.losses).all()
    late, early = result.losses[-10:].mean(), result.losses[:5].mean()
    assert float(late) < 0.8 * float(early), (float(early), float(late))
    err1 = float(torch.mean(torch.abs(
        _target(result.gaussians, c2w, k_norm, hw) - target)))
    assert err1 < 0.75 * err0, (err0, err1)


def test_views_are_drawn_from_the_seed(scene):  # noqa: F811
    drawn = [int(torch.randint(0, 3, (), generator=tpo._draw(7, s,
                                                             tpo.DRAW_VIEW)))
             for s in range(12)]
    again = [int(torch.randint(0, 3, (), generator=tpo._draw(7, s,
                                                             tpo.DRAW_VIEW)))
             for s in range(12)]
    assert drawn == again and set(drawn) <= {0, 1, 2}
    assert len(set(drawn)) > 1
