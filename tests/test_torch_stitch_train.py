"""Stitching distillation: the port's trainer against the JAX package's.

The tiny stitched config of `test_torch_slice.py` (ViT of 4 blocks chopped
at 2, 4 aggregator pairs tapped at each, 56² images, so P = 16 + 5 = 21
tokens, unpadded in the training layout), LoRA `r2,a4`, 5 views.  Weights
come from the JAX package's `init` through `convert` (the camera head's
pose-branch bias set as in the slice tests, so the cameras are real); the
inputs are made with numpy from a seed.  JAX runs on the CPU with its XLA
attention, the port with its plain attention (the flash kernels are held
against that on the card).

Tolerances, each relative to the largest magnitude of what it compares:
  * forwards, VAE encode and loss terms: 1e-4 — fp32 on both sides, sums
    in another order through a dozen blocks and two DPT cascades (observed
    ≤ 6e-7);
  * loss gradients: 1e-3 per trainable leaf (observed ≤ 6.7e-5: every
    gradient passes the whole student backward, remat included), except
    the GS head's, 1e-2 (observed ≤ 4.6e-3).  There the rotations term
    differs: an L1 term weighs each element by the sign of student −
    teacher, and where the two sit within rounding of each other the sign
    is the summation order's, while the quaternion normalisation behind it
    has a gradient of 1/‖q‖ (JAX's |x|′ is also +1 at 0, torch's 0);
  * the trainable state after three steps (warmup 1, so lr = 0, then the
    peak, then the cosine): Adam divides each gradient by its own running
    RMS, so an element whose gradient sits at the noise floor may move by
    up to lr either way in either package.  Elements whose first gradient
    is above 1e-2 of its leaf's largest (gradients agree to ≤ 1e-4 of
    that largest, so to ≤ 1 % of theirs) must agree within 10 % of the
    summed lr (observed ≤ 2.5 %); every element within Adam's bound,
    2·lr per step (observed ≤ 0.31 of the summed lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_slice import CAMERA_BIAS, _configs
from vist3a_tpu.nn import aggregator as jagg
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import wan_vae as jvae
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu.train import stitching as jst
from vist3a_tpu.train.losses import (gradient_loss_multi_scale as j_gl,
                                     task_loss as j_task_loss)
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.cli import train_stitching as tcli
from vist3a_tpu_torch.nn import aggregator as tagg
from vist3a_tpu_torch.nn import encoder as tenc
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.nn.gaussians import Gaussians
from vist3a_tpu_torch.stitch import chopped_anysplat as tca
from vist3a_tpu_torch.train import losses as tlosses
from vist3a_tpu_torch.train import stitching as tst

K_CHOP = 2
S, T_VAE, IMG = 5, 2, 56
LORA = "r2,a4,d0.0,f0"
FWD_RTOL = 1e-4
GRAD_RTOL = 1e-3
GS_GRAD_RTOL = 1e-2    # the GS head's leaves (see the module docstring)
LIVE_GRAD = 1e-2       # of the leaf's largest first gradient
LIVE_ATOL = 0.1        # of the summed lr


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: under the suite's parallel workers, torch's
    intra-op threads oversubscribe the cores and slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    params = {"encoder": jenc.init(jax.random.key(0), jcfg.encoder),
              "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg)}
    params["encoder"]["camera_head"]["pose_branch"]["fc2"]["b"] = \
        jnp.asarray(CAMERA_BIAS)
    flat = convert.from_jax_params(_to_np(params))
    teacher = tenc.Encoder(tcfg.encoder, vit_start=0)
    convert.load_jax_encoder_params(teacher, _to_np(params["encoder"]))
    teacher.requires_grad_(False)
    stitch_conv = tca.init_stitch_conv(tcfg)
    stitch_conv.load_state_dict({k.split(".", 1)[1]: v for k, v in
                                 flat.items() if k.startswith("stitch_conv")})
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((1, 16, T_VAE, IMG // 8, IMG // 8)
                                 ).astype(np.float32)
    images = rng.uniform(-1, 1, (1, 3, S, IMG, IMG)).astype(np.float32)
    t01 = np.ascontiguousarray(np.swapaxes((images + 1) * 0.5, 1, 2))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, teacher=teacher,
                stitch_conv=stitch_conv, latent=latent, images=images,
                t01=t01)


def _torch_output(out: jenc.EncoderOutput) -> tenc.EncoderOutput:
    t = lambda x: torch.from_numpy(np.array(x))          # noqa: E731
    return tenc.EncoderOutput(
        gaussians=Gaussians(*map(t, out.gaussians)),
        pred_pose_enc_list=[t(x) for x in out.pred_pose_enc_list],
        **{k: t(v) for k, v in out._asdict().items()
           if k not in ("gaussians", "pred_pose_enc_list")})


@pytest.fixture(scope="module")
def jax_teacher_out(setup):
    return jax.jit(jenc.forward, static_argnames="cfg")(
        setup["params"]["encoder"], jnp.asarray(setup["t01"]),
        cfg=setup["jcfg"].encoder)


def test_gradient_loss_multi_scale_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((2, 5, 17, 16, 1)).astype(np.float32) * 3
    tgt = rng.standard_normal((2, 5, 17, 16, 1)).astype(np.float32)
    want = float(j_gl(jnp.asarray(pred), jnp.asarray(tgt)))
    got = tlosses.gradient_loss_multi_scale(torch.from_numpy(pred),
                                            torch.from_numpy(tgt)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_task_loss_matches_jax_term_by_term(jax_teacher_out):
    """The JAX teacher's outputs against a perturbed copy of them (every
    float leaf scaled and shifted by a seeded amount), fed to both
    losses."""
    rng = np.random.default_rng(5)

    def perturb(x):
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        return x * (1 + 0.1 * rng.standard_normal(x.shape).astype(
            np.float32)) + 0.01
    other = jax.tree_util.tree_map(perturb, jax_teacher_out)
    want = j_task_loss(other, jax_teacher_out)
    got = tlosses.task_loss(_torch_output(other),
                            _torch_output(jax_teacher_out))
    assert set(got) == set(want) and len(got) == 15
    for k, v in want.items():
        assert float(v) > 0, k
        assert got[k].item() == pytest.approx(float(v), rel=FWD_RTOL), k


def test_teacher_forward_matches_jax(setup, jax_teacher_out):
    """The full encoder from images (the patch embedding, all 4 ViT blocks,
    the unpadded trunk) against `encoder.forward`."""
    with torch.no_grad():
        got = tenc.forward(setup["teacher"], torch.from_numpy(setup["t01"]),
                           setup["tcfg"].encoder)
    want = jax_teacher_out
    for name, g, w in (("means", got.gaussians.means, want.gaussians.means),
                       ("harmonics", got.gaussians.harmonics,
                        want.gaussians.harmonics),
                       ("depth", got.depth, want.depth),
                       ("depth_conf", got.depth_conf, want.depth_conf),
                       ("anchor_feats", got.anchor_feats, want.anchor_feats),
                       ("pose", got.pred_pose_enc_list[-1],
                        want.pred_pose_enc_list[-1]),
                       ("extrinsic_c2w", got.extrinsic_c2w,
                        want.extrinsic_c2w)):
        assert _rel(g, w) <= FWD_RTOL, name
    np.testing.assert_array_equal(got.conf_valid_mask.numpy(),
                                  np.asarray(want.conf_valid_mask))


def test_run_trunk_remat_matches_jax_and_the_padded_layout(setup):
    """The training layout (P = 21 unpadded, per-pair recompute) against
    JAX `run_trunk(remat=True)`, and against the port's padded inference
    layout (P 21 → 32, masked keys); gradients flow through the remat."""
    jcfg, tcfg, params = setup["jcfg"], setup["tcfg"], setup["params"]
    acfg = tcfg.encoder.agg
    rng = np.random.default_rng(2)
    tokens = rng.standard_normal((1, 3, 21, 32)).astype(np.float32)
    _, want = jax.jit(jagg.run_trunk, static_argnums=(2, 3),
                      static_argnames="remat")(
        params["encoder"]["aggregator"], jnp.asarray(tokens),
        jcfg.encoder.agg, (4, 4), remat=True)
    agg = setup["teacher"].aggregator
    x = torch.from_numpy(tokens).requires_grad_()
    _, got = tagg.run_trunk(agg, x, acfg, (4, 4), remat_pairs=True)
    with torch.no_grad():
        _, padded = tagg.run_trunk(agg, x, acfg, (4, 4))
    for g, w, p in zip(got, want, padded):
        assert _rel(g, w) <= FWD_RTOL
        assert _rel(g, p.numpy()) <= FWD_RTOL
    sum(t.sum() for t in got).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_vae_encode_matches_jax():
    """A narrow Wan VAE encoder (base 8, both temporal downsamples) on 9
    frames: mu and logvar against `wan_vae.encode`; T ≢ 1 (mod 4) raises."""
    jcfg = jvae.WanVAEConfig(base_dim=8)
    tcfg = tvae.WanVAEConfig(base_dim=8)
    params = {"encoder": jvae.encoder_init(jax.random.key(5), jcfg),
              "quant_conv": jvae.conv3d_init(jax.random.key(6), 32, 32,
                                             (1, 1, 1))}
    model = tvae.WanVAEEncoder(tcfg)
    convert.load_jax_vae_params(model, _to_np(params))
    video = np.random.default_rng(3).uniform(-1, 1, (1, 3, 9, 24, 24)
                                             ).astype(np.float32)
    mu_w, lv_w = jax.jit(jvae.encode, static_argnums=2)(
        params, jnp.asarray(video), jcfg)
    mu, lv = tvae.encode(model, torch.from_numpy(video))
    assert tuple(mu.shape) == (1, 16, 3, 3, 3)
    assert _rel(mu, mu_w) <= FWD_RTOL and _rel(lv, lv_w) <= FWD_RTOL
    with pytest.raises(ValueError, match="mod 4"):
        tvae.encode(model, torch.zeros(1, 3, 8, 24, 24))


def test_sample_posterior_clamps_and_scales():
    """z = mu + exp(clamp(logvar, −30, 20) / 2)·ε, ε from the generator —
    the JAX formula (its ε comes from threefry, so only the rule is
    compared)."""
    mu = torch.linspace(-1, 1, 40).reshape(1, 2, 20)
    logvar = torch.linspace(-45, 35, 40).reshape(1, 2, 20)
    z = tvae.sample_posterior(mu, logvar, torch.Generator().manual_seed(9))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(9))
    std = np.array(jnp.exp(0.5 * jnp.clip(jnp.asarray(logvar.numpy()),
                                          -30.0, 20.0)))
    torch.testing.assert_close(z, mu + torch.from_numpy(std) * eps)


@pytest.mark.parametrize("warmup,total", [(1, 10), (3, 12), (0, 5)])
def test_lr_schedule_matches_optax(warmup, total):
    cfg = tst.StitchTrainConfig(learning_rate=3e-4, warmup_steps=warmup,
                                total_steps=total)
    jcfg = jst.StitchTrainConfig(learning_rate=3e-4, warmup_steps=warmup,
                                 total_steps=total)
    sched = jst.lr_schedule(jcfg) if warmup else \
        optax.cosine_decay_schedule(3e-4, total)
    for step in range(total + 2):
        assert tst.lr_schedule(cfg, step) == pytest.approx(
            float(sched(step)), rel=1e-6, abs=1e-12)


def test_view_counts_are_the_reference_draws():
    """The reference's four counts, the same for a (seed, step) every time,
    and another sequence for another seed."""
    draws = [tst.sample_view_count(23, s) for s in range(64)]
    assert set(draws) == set(tst.VIEW_COUNTS) == set(jst.VIEW_COUNTS)
    assert draws == [tst.sample_view_count(23, s) for s in range(64)]
    assert draws != [tst.sample_view_count(24, s) for s in range(64)]


def _random_b(trainable, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(trainable["lora"])
    lora = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if getattr(path[-1], "key", None) == "b" else x
        for path, x in leaves])
    return {"lora": lora, "model": trainable["model"]}


@pytest.fixture(scope="module")
def trained(setup):
    """Both packages from one initial state (the JAX init, B factors made
    random and nonzero, carried over to the port): the loss gradients at
    that state, and the state after three steps."""
    jcfg, tcfg, params = setup["jcfg"], setup["tcfg"], setup["params"]
    jtc = jst.StitchTrainConfig(lora_spec=LORA, warmup_steps=1,
                                total_steps=10)
    ttc = tst.StitchTrainConfig(lora_spec=LORA, warmup_steps=1,
                                total_steps=10)
    state, _ = jst.init_train_state(jax.random.key(3), params, jtc)
    jtrain = _random_b(state.trainable, 7)
    latent, images = jnp.asarray(setup["latent"]), jnp.asarray(setup["images"])
    jstate = jst.TrainState(jnp.zeros((), jnp.int32),
                            jax.tree_util.tree_map(jnp.array, jtrain),
                            jst.build_optimizer(jtc).init(jtrain))
    jmetrics, jgrads = [], None
    for _ in range(3):
        jstate, m = jst.stitch_train_step(
            jstate, params["encoder"], latent, images,
            jnp.asarray(setup["t01"]), jcfg, jcfg.encoder,
            lora_spec=LORA, train_cfg=jtc)
        jmetrics.append({k: float(v) for k, v in m.items()})
        if jgrads is None:
            # step 0 runs at lr 0, so its gradient is Adam's first moment
            # over (1 − β1), unclipped by ‖g‖ where ‖g‖ ≥ 1 (optax clips)
            mu = next(s.mu for s in jax.tree_util.tree_leaves(
                jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu")))
            unclip = max(1.0, jmetrics[0]["grad_norm"])
            jgrads = jax.tree_util.tree_map(
                lambda x: np.asarray(x) / (1 - jtc.betas[0]) * unclip, mu)

    teacher = setup["teacher"]
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    tstate, frozen = tst.init_train_state(torch.Generator().manual_seed(0),
                                          teacher, setup["stitch_conv"],
                                          tcfg, ttc)
    start = convert.trainable_from_jax(_to_np(jtrain), K_CHOP)
    with torch.no_grad():
        for site, f in tstate.trainable["lora"].items():
            for k in ("a", "b"):
                f[k].copy_(start["lora"][site][k])
        for name, p in tstate.trainable["model"].items():
            p.copy_(start["model"][name])
    with torch.no_grad():
        tout_t = tenc.forward(teacher, torch.from_numpy(setup["t01"]),
                              tcfg.encoder)
    total, tlosses_ = tst.loss_fn(tstate.trainable, frozen, tout_t,
                                  torch.from_numpy(setup["latent"]),
                                  torch.from_numpy(setup["images"]), tcfg,
                                  ttc.lora)
    total.backward()
    tgrads = {"lora": {s: {k: f[k].grad.clone() for k in ("a", "b")}
                       for s, f in tstate.trainable["lora"].items()},
              "model": {n: p.grad.clone()
                        for n, p in tstate.trainable["model"].items()}}
    tmetrics = []
    for _ in range(3):
        m = tst.stitch_train_step(tstate, teacher,
                                  torch.from_numpy(setup["latent"]),
                                  torch.from_numpy(setup["images"]),
                                  torch.from_numpy(setup["t01"]), tcfg, ttc)
        tmetrics.append({k: float(v) for k, v in m.items()})
    return dict(jgrads=convert.trainable_from_jax(jgrads, K_CHOP),
                tgrads=tgrads, tlosses=tlosses_,
                jfinal=convert.trainable_from_jax(
                    _to_np(jstate.trainable), K_CHOP),
                tstate=tstate, frozen=frozen, start=start,
                jmetrics=jmetrics, tmetrics=tmetrics, before=before,
                lrs=[tst.lr_schedule(ttc, s) for s in range(3)])


def _leaves(tree):
    yield from ((f"lora.{s}.{k}", f[k]) for s, f in tree["lora"].items()
                for k in ("a", "b"))
    yield from ((f"model.{n}", v) for n, v in tree["model"].items())


def test_loss_fn_value_and_gradients_match_jax(trained):
    """`loss_fn` at the initial state against the JAX step's first losses
    and gradient."""
    for k, v in trained["jmetrics"][0].items():
        if k in trained["tlosses"]:
            assert trained["tlosses"][k].item() == pytest.approx(
                v, rel=FWD_RTOL), k
    want = dict(_leaves(trained["jgrads"]))
    got = dict(_leaves(trained["tgrads"]))
    assert set(got) == set(want) and len(got) > 300
    for name, g in got.items():
        tol = GS_GRAD_RTOL if ".gs_head." in name else GRAD_RTOL
        assert _rel(g, want[name]) <= tol, name


def test_three_train_steps_match_jax(trained):
    jm, tm = trained["jmetrics"], trained["tmetrics"]
    for a, b in zip(jm, tm):
        assert set(b) == set(a)
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=FWD_RTOL, abs=1e-12), k
    assert tm[0]["lr"] == 0 and tm[1]["lr"] > 0
    lr_sum = sum(trained["lrs"])
    final = dict(_leaves({"lora": {s: {k: f[k].detach() for k in ("a", "b")}
                                   for s, f in
                                   trained["tstate"].trainable["lora"].items()},
                          "model": {n: p.detach() for n, p in
                                    trained["tstate"].trainable["model"]
                                    .items()}}))
    want = dict(_leaves(trained["jfinal"]))
    g0 = dict(_leaves(trained["jgrads"]))
    start = dict(_leaves(trained["start"]))
    moved = 0
    for n, w in want.items():
        diff = (final[n] - w).abs()
        assert diff.max().item() <= 2 * lr_sum, n
        live = g0[n].abs() > LIVE_GRAD * g0[n].abs().max()
        if live.any():
            assert diff[live].max().item() <= LIVE_ATOL * lr_sum, n
        moved += not torch.equal(final[n], start[n])
    assert moved == len(want)


def test_frozen_tensors_are_the_teachers_and_unchanged(trained, setup):
    teacher = setup["teacher"]
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, trained["before"][k]), k
    own = {f"encoder.{k}": v for k, v in teacher.named_parameters()}
    assert trained["frozen"] and all(t is own[n] for n, t in
                                     trained["frozen"].items())
    model = trained["tstate"].trainable["model"]
    assert all(p.data_ptr() != own[n].data_ptr() for n, p in model.items()
               if n in own)


def test_run_over_an_in_memory_loader(setup, tmp_path):
    """`run` over two batches of a 21-frame clip: the view counts drawn,
    the VAE encode, two steps, the history (checkpoints are
    `test_torch_checkpoints.py`'s)."""
    tcfg = setup["tcfg"]
    vae = tvae.init_encoder(tvae.WanVAEConfig(base_dim=8),
                            torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(4)
    clip = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 21, IMG, IMG))
                            .astype(np.float32))
    batch = {"vae_image_tensor": clip, "feedforward_image_tensor": clip}
    params = {"encoder": setup["teacher"], "vae": vae,
              "stitch_conv": setup["stitch_conv"]}
    cfg = tst.StitchTrainConfig(lora_spec=LORA, warmup_steps=1,
                                total_steps=4)
    # seed 6 draws 9 views, then 13
    state, history = tcli.run(params, tcfg, [batch, batch], train_cfg=cfg,
                              num_epochs=1, seed=6, log_every=1)
    assert state.step == 2 and [h["step"] for h in history] == [0, 1]
    assert [h["views"] for h in history] == [tst.sample_view_count(6, s)
                                             for s in range(2)] == [9, 13]
    for h in history:
        assert np.isfinite(h["total_loss"]) and h["grad_norm"] > 0
    # an empty loader takes no step; the epoch's checkpoint is still saved
    empty, none = tcli.run(params, tcfg, [], train_cfg=cfg, num_epochs=1,
                           save_path=tmp_path)
    assert empty.step == 0 and none == []
    assert (tmp_path / "stitched_model_epoch_0.pt").exists()
    assert dataclasses.is_dataclass(state)
