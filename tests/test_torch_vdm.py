"""The port's VDM fine-tuning (`train/vdm.py`, `cli/train_vdm.py`) against
the JAX package's.

Tiny configs of `tests/test_vdm_training.py`: the Wan DiT at dim 48 (2
layers of 4 heads, text 24), the Wan VAE at base 8, the CLIP towers at
width 32, and the stitched decoder of `tests/test_torch_slice.py` (its
`tiny_encoder_cfg`); weights from the JAX `init` carried over by
`convert`, inputs made with numpy or JAX from a seed.  The JAX draws
(rollout length, indices, guidance, posterior and flow noise, initial
latents, view permutation, decoded frame) are handed to the port.

Tolerances, relative to the largest magnitude of what is compared unless
stated:
  * flow batch and loss, EMA, record/replay: 1e-6 (the same fp32
    arithmetic; replay equals record exactly);
  * rollout value 1e-5 and LoRA gradients 1e-4 against both JAX forms (the
    index form and the masked-scan oracle; fp32 through 4 UniPC steps of
    the DiT, sums in another order; observed ≤ 4.1e-7 and 3.9e-6);
  * the whole step: the SFT loss 1e-3, the reward loss 2e-3, the gradient
    norm 1e-2 and the gradients (read from Adam's first moment, 0.1·g after
    one step in both packages) ‖Δ‖/‖g‖ ≤ 5e-2.  The step encodes and
    decodes in bf16 activations, where JAX and PyTorch round their
    convolutions differently (observed 3.4e-5, 9.4e-5, 2.0e-3 and
    1.9e-2).  After the step each LoRA element lies within 2·lr of JAX's
    and the EMA within 0.9 of that (d = 0.1 at step 0): Adam's first step
    moves an element by lr·g/|g|, so an element whose gradient sits at the
    noise floor may go either way (observed 1.9996·lr) — a bound, not a
    tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import CAMERA_BIAS, _configs
from vist3a_tpu.diffusion import flow_match as jfm
from vist3a_tpu.diffusion import unipc as junipc
from vist3a_tpu.nn import clip as jclip
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import wan_dit as jdit
from vist3a_tpu.nn import wan_vae as jvae
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu.train import ema as jema
from vist3a_tpu.train import reward as jrew
from vist3a_tpu.train import vdm as jvdm
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.cli import train_vdm as tcli
from vist3a_tpu_torch.diffusion import flow_match as tfm
from vist3a_tpu_torch.diffusion import unipc as tunipc
from vist3a_tpu_torch.nn import clip as tclip
from vist3a_tpu_torch.nn import wan_dit as tdit
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.stitch import chopped_anysplat as tca
from vist3a_tpu_torch.stitch import lora as tlora
from vist3a_tpu_torch.train import ema as tema
from vist3a_tpu_torch.train import reward as trew
from vist3a_tpu_torch.train import vdm as tvdm

DIT = dict(dim=48, ffn_dim=96, num_layers=2, num_heads=4, freq_dim=32,
           text_dim=24)
VAE = dict(base_dim=8, z_dim=16, num_res_blocks=1)
CL = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
          patch_size=8, image_size=32, projection_dim=16)
LAT = (1, 16, 2, 8, 8)
LR = 1e-4


def T(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dit():
    jcfg = jdit.WanDiTConfig(**DIT, attn_impl="xla")
    params = jdit.init(jax.random.key(0), jcfg)
    model = convert.load_jax_dit_params(tdit.WanDiT(tdit.WanDiTConfig(**DIT)),
                                        _np(params)).requires_grad_(False)
    return jcfg, params, model


def test_config_and_lora_targets_match_jax(dit):
    assert tvdm.VDM_LORA_SPEC == jvdm.VDM_LORA_SPEC
    jc, tc = jvdm.VDMTrainConfig(), tvdm.VDMTrainConfig()
    assert {k: v for k, v in dataclasses.asdict(jc).items()} == \
        dataclasses.asdict(tc)
    sites = tlora.lora_sites(dit[2], tc.lora)
    assert len(sites) == 8 * DIT["num_layers"]
    assert {s.split(".", 2)[2] for s in sites} == {
        "attn1.q", "attn1.k", "attn1.v", "attn1.o",
        "attn2.q", "attn2.k", "attn2.v", "attn2.o"}
    assert tc.lora.r == 8 and tc.lora.alpha == 16
    state = tvdm.init_train_state(torch.Generator().manual_seed(0), dit[2],
                                  tc)
    jstate = jvdm.init_train_state(jax.random.key(1), dit[1], jc)
    jl = convert.dit_lora_from_jax(_np(jstate.lora))
    assert set(jl) == set(state.lora)
    for s, f in state.lora.items():
        assert all(f[k].shape == jl[s][k].shape for k in "ab")
        assert float(f["b"].detach().abs().max()) == 0.0
    assert set(state.ema) == set(tvdm.flat_lora(state.lora))


def test_synced_draws_and_prompts():
    assert tvdm.choose_and_sync_steps(0, 20) == 50      # every 10th step
    a = tvdm.choose_and_sync_steps(3, 7, 10, 50)
    assert a == tvdm.choose_and_sync_steps(3, 7, 10, 50) and 10 <= a <= 50
    i = tvdm.choose_and_sync_two_indices(3, 7, 12)
    assert len(i) == 2 and i[0] != i[1] and max(i) < 12
    assert 4.0 <= tvdm.choose_guidance_scale(3, 7) <= 6.0
    for n, want in ((13, 20), (10, 10), (41, 50), (50, 50)):
        assert tvdm.bucket_rollout_steps(n, 10, 50) == \
            jvdm.bucket_rollout_steps(n, 10, 50) == want
    assert tvdm.bucket_rollout_steps(7, 0, 50) == 7
    d = tvdm.draw_step(3, 7, tvdm.VDMTrainConfig(), rl=True)
    assert d["backprop_idx"][-1] == d["num_steps"] - 1
    assert d["num_steps"] % 10 == 0
    assert tvdm.camera_prompt_templates("a cat") == \
        jvdm.camera_prompt_templates("a cat")
    assert len(tvdm.camera_prompt_templates("x")) == 83
    outs = {tvdm.augment_camera_prompt(np.random.default_rng(i), "a cat")
            for i in range(60)}
    assert len(outs) > 20 and all("a cat" in o for o in outs)


def test_flow_batch_and_loss_match_jax():
    z0 = jax.random.normal(jax.random.key(0), LAT)
    key = jax.random.key(1)
    want = jfm.make_flow_batch(key, z0)
    k_eps, k_sig = jax.random.split(key)
    got = tfm.make_flow_batch(T(z0), eps=T(jax.random.normal(k_eps, LAT)),
                              sigma=T(jax.random.uniform(k_sig, (1,))))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-6
    pred = jax.random.normal(jax.random.key(2), LAT)
    assert _rel(tfm.flow_matching_loss(T(pred), got[2]),
                jfm.flow_matching_loss(pred, want[2])) <= 1e-6
    g = torch.Generator().manual_seed(0)
    zs, ts, tgt = tfm.make_flow_batch(T(z0), g)
    assert zs.shape == LAT and 0 <= float(ts[0]) <= 1000


def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    p0 = {"x": rng.standard_normal((3, 4)).astype(np.float32),
          "y": rng.standard_normal(5).astype(np.float32)}
    p1 = {k: v + 1.0 for k, v in p0.items()}
    cfg = tema.EMAConfig(decay=0.99)
    for step in (0, 3, 500):
        assert tema.current_decay(step) == pytest.approx(
            float(jema.current_decay(step)), rel=1e-7)
        want = jema.update_ema(jema.init_ema(p0), p1, step,
                               jema.EMAConfig(decay=0.99))
        ema = tema.init_ema({k: T(v) for k, v in p0.items()})
        tema.update_ema(ema, {k: T(v) for k, v in p1.items()}, step, cfg)
        for k in p0:
            assert _rel(ema[k], want[k]) <= 1e-6
    half = {k: T(v).to(torch.bfloat16) for k, v in p0.items()}
    cast = tema.ema_params_like(tema.init_ema(half), half)
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    # an update interval of 2 skips even steps
    ema = tema.init_ema({"x": torch.zeros(2)})
    tema.update_ema(ema, {"x": torch.ones(2)}, 0, tema.EMAConfig(0.99, 2))
    assert float(ema["x"].abs().max()) == 0.0


def test_record_and_replay_match_jax():
    """`sample_scan_record` and `replay_affine` against JAX's on a model
    that is a fixed nonlinear function of (x, t); the replay of the
    recorded outputs reproduces the rollout exactly."""
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32)
    w = rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32)
    ucfg = dict(num_steps=5, shift=3.0)

    def jmodel(x, t):
        return jnp.tanh(x * w) + t / 1000.0

    def tmodel(x, t):
        return torch.tanh(x * T(w)) + t / 1000.0
    jx, jxs, jvs = junipc.sample_scan_record(jmodel, jnp.asarray(lat),
                                             junipc.UniPCConfig(**ucfg))
    x, xs, vs = tunipc.sample_scan_record(tmodel, T(lat),
                                          tunipc.UniPCConfig(**ucfg))
    assert xs.shape == vs.shape == (5, *lat.shape)
    for g, want in ((x, jx), (xs, jxs), (vs, jvs)):
        assert _rel(g, want) <= 1e-6
    replay = tunipc.replay_affine(vs, T(lat), tunipc.UniPCConfig(**ucfg))
    assert torch.equal(replay, x)
    assert _rel(replay, junipc.replay_affine(jvs, jnp.asarray(lat),
                                             junipc.UniPCConfig(**ucfg))) \
        <= 1e-6
    assert torch.equal(tunipc.sample_scan(tmodel, T(lat),
                                          tunipc.UniPCConfig(**ucfg)), x)


@pytest.mark.parametrize("idx,mask", [([0, 2, 3], [1.0, 0.0, 1.0, 1.0]),
                                      ([1, 3, 3], [0.0, 1.0, 0.0, 1.0])])
def test_rollout_gradients_match_both_jax_forms(dit, idx, mask):
    """The index form (record, one batched re-evaluation, replay) against
    JAX's index form and its masked-scan oracle: value and LoRA gradients;
    a drawn index equal to the forced last step counts once."""
    jcfg, params, model = dit
    cfg = jvdm.VDMTrainConfig(enable_rl=True)
    state = jvdm.init_train_state(jax.random.key(1), params, cfg)
    lora = jax.tree_util.tree_map(lambda x: x, state.lora)
    # nonzero B factors, so that every factor has a gradient
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * jax.random.normal(
            jax.random.key(len(str(p))), x.shape)
        if str(p[-1]) == "['b']" else x, lora)
    cond = jax.random.normal(jax.random.key(2), (1, 5, DIT["text_dim"]))
    uncond = jnp.zeros_like(cond)
    lat0 = jax.random.normal(jax.random.key(3), LAT)

    def jout(lora, **kw):
        m = jvdm.merged_dit(params, lora, cfg)
        return jnp.sum(jvdm.rollout(m, lat0, cond, uncond, jcfg, num_steps=4,
                                    guidance_scale=5.0, **kw) ** 2)
    v_idx, g_idx = jax.value_and_grad(
        lambda l: jout(l, backprop_idx=jnp.asarray(idx, jnp.int32)))(lora)
    v_mask, g_mask = jax.value_and_grad(
        lambda l: jout(l, backprop_mask=jnp.asarray(mask)))(lora)
    tl = {s: {k: torch.nn.Parameter(v) for k, v in f.items()}
          for s, f in convert.dit_lora_from_jax(_np(lora)).items()}
    out = tvdm.rollout(model, T(lat0), T(cond), T(uncond), num_steps=4,
                       guidance_scale=5.0, backprop_idx=idx, lora=tl,
                       lora_cfg=tvdm.VDMTrainConfig().lora)
    value = (out ** 2).sum()
    value.backward()
    assert _rel(value, v_idx) <= 1e-5 and _rel(value, v_mask) <= 1e-5
    for want in (g_idx, g_mask):
        wl = convert.dit_lora_from_jax(_np(want))
        for s, f in tl.items():
            for k in "ab":
                assert _rel(f[k].grad, wl[s][k]) <= 1e-4, (s, k)


@pytest.fixture(scope="module")
def tiny_models(dit):
    jdcfg, dparams, tdit_m = dit
    jvcfg, tvcfg = jvae.WanVAEConfig(**VAE), tvae.WanVAEConfig(**VAE)
    jscfg, tscfg = _configs()
    jscfg = dataclasses.replace(jscfg, vae=jvcfg)
    vae = jvae.init(jax.random.key(1), jvcfg)
    stitched = {"encoder": jenc.init(jax.random.key(2), jscfg.encoder),
                "stitch_conv": jca.init_stitch_conv(jax.random.key(3),
                                                    jscfg)}
    stitched["encoder"]["camera_head"]["pose_branch"]["fc2"]["b"] = \
        jnp.asarray(CAMERA_BIAS)
    jccfg, tccfg = jclip.CLIPVisionConfig(**CL), tclip.CLIPVisionConfig(**CL)
    pick, pe = (jclip.init(jax.random.key(i), jccfg) for i in (4, 5))
    frozen = lambda m: m.requires_grad_(False)              # noqa: E731
    port = dict(
        dit=tdit_m,
        enc=frozen(convert.load_jax_vae_params(tvae.WanVAEEncoder(tvcfg),
                                               _np(vae))),
        dec=frozen(convert.load_jax_vae_params(tvae.WanVAEDecoder(tvcfg),
                                               _np(vae))),
        stitched=frozen(convert.load_jax_params(tca.StitchedDecoder(tscfg),
                                                _np(stitched))),
        loss=trew.make_loss_fn(
            *(frozen(convert.load_jax_clip_vision_params(
                tclip.CLIPVision(tccfg), _np(p))) for p in (pick, pe)),
            logit_scale=100.0,
            cfg=trew.RewardConfig(pick_cfg=tccfg, pe_cfg=tccfg)),
        scfg=tscfg)
    jax_side = dict(dit=dparams, dcfg=jdcfg, vae=vae, vcfg=jvcfg,
                    stitched=stitched, scfg=jscfg,
                    loss=jrew.make_loss_fn(pick, pe, logit_scale=100.0,
                                           cfg=jrew.RewardConfig(
                                               pick_cfg=jccfg,
                                               pe_cfg=jccfg)))
    return jax_side, port


def test_whole_step_matches_jax(tiny_models):
    """One VDM step in both packages from one state (B factors nonzero, so
    every factor has a gradient): losses, gradient norm, gradients, and the
    LoRA and EMA after the step."""
    j, p = tiny_models
    cfg = jvdm.VDMTrainConfig(enable_rl=True, rollout_steps_low=3,
                              rollout_steps_high=3)
    state = jvdm.init_train_state(jax.random.key(7), j["dit"], cfg)
    lora = jax.tree_util.tree_map_with_path(
        lambda path, x: 0.02 * jax.random.normal(
            jax.random.key(len(str(path))), x.shape)
        if str(path[-1]) == "['b']" else x, state.lora)
    state = state._replace(lora=lora, ema=jema.init_ema(lora))
    video = jax.random.uniform(jax.random.key(8), (1, 3, 5, 64, 64),
                               minval=-1, maxval=1)
    text = jax.random.normal(jax.random.key(9), (1, 5, DIT["text_dim"]))
    feat = jax.random.normal(jax.random.key(6), (1, 16))
    feat = feat / jnp.linalg.norm(feat)
    key = jax.random.key(10)
    jstate, jm = jvdm.vdm_train_step(
        state, j["dit"], j["vae"], j["stitched"], video=video,
        sft_text=text, rl_cond=text, rl_uncond=jnp.zeros_like(text),
        reward_loss_fn=j["loss"], key=key, dit_cfg=j["dcfg"],
        vae_cfg=j["vcfg"], scfg=j["scfg"], cfg=cfg, latent_shape=LAT,
        render_size=56, reward_text=(feat, feat))

    k_vae, k_flow, k_noise, k_reward = jax.random.split(
        jax.random.fold_in(key, 0), 4)
    n = jvdm.choose_and_sync_steps(key, 0, 3, 3)
    bp = jvdm.choose_and_sync_two_indices(key, 0, n)
    k_eps, k_sig = jax.random.split(k_flow)
    k_views, k_frame = jax.random.split(k_reward)
    draws = {"num_steps": n, "backprop_idx": bp + [n - 1],
             "guidance": jvdm.choose_guidance_scale(key, 0),
             "posterior_eps": T(jax.random.normal(k_vae, LAT)),
             "flow_eps": T(jax.random.normal(k_eps, LAT)),
             "flow_sigma": T(jax.random.uniform(k_sig, (1,))),
             "latents0": T(jax.random.normal(k_noise, LAT)),
             "perm": T(jax.random.permutation(k_views, 5)),
             "frame": int(jax.random.randint(k_frame, (1,), 0, 5)[0])}
    tcfg = tvdm.VDMTrainConfig(enable_rl=True, rollout_steps_low=3,
                               rollout_steps_high=3)
    pstate = tvdm.init_train_state(torch.Generator().manual_seed(0),
                                   p["dit"], tcfg)
    convert.vdm_state_from_jax(_np(state), pstate)
    m = tvdm.vdm_train_step(
        pstate, p["dit"], p["enc"], p["dec"], p["stitched"], video=T(video),
        sft_text=T(text), rl_cond=T(text), rl_uncond=torch.zeros(T(text).shape),
        reward_loss_fn=p["loss"], seed=0, scfg=p["scfg"], cfg=tcfg,
        latent_shape=LAT, render_size=56, reward_text=(T(feat), T(feat)),
        draws=draws)
    assert pstate.step == int(jstate.step) == 1
    assert not m["skipped"] and not bool(jm["skipped"])
    assert m["backprop_idx"] == [0, 2, 2]
    assert _rel(m["diffusion_loss"], jm["diffusion_loss"]) <= 1e-3
    assert _rel(m["reward_loss"], jm["reward_loss"]) <= 2e-3
    assert _rel(m["grad_norm"], jm["grad_norm"]) <= 1e-2
    mu = convert.dit_lora_from_jax(_np(convert._adam_state(
        jstate.opt_state).mu))
    num = den = 0.0
    for s, f in pstate.lora.items():
        for k in "ab":
            got = pstate.optimizer.state[f[k]]["exp_avg"]
            num += float(((got - mu[s][k]) ** 2).sum())
            den += float((mu[s][k] ** 2).sum())
    assert (num / den) ** 0.5 <= 5e-2
    lj = convert.dit_lora_from_jax(_np(jstate.lora))
    ej = convert.dit_lora_from_jax(_np(jstate.ema))
    for s, f in pstate.lora.items():
        for k in "ab":
            assert float((f[k].detach() - lj[s][k]).abs().max()) <= 2 * LR
            assert float((pstate.ema[f"{s}.{k}"] - ej[s][k]).abs().max()) \
                <= 0.9 * 2 * LR + 1e-7


def test_run_two_steps_in_memory(tiny_models):
    """`cli.train_vdm.run` over in-memory loaders: two steps (the second
    restarts the one-batch video loader), finite losses, the LoRA moved,
    the EMA at its warm-up formula, `save_path` refused until slice 6."""
    _, p = tiny_models
    cfg = tvdm.VDMTrainConfig(enable_rl=True, rollout_steps_low=2,
                              rollout_steps_high=3)
    state = tvdm.init_train_state(torch.Generator().manual_seed(1), p["dit"],
                                  cfg)
    gen = torch.Generator().manual_seed(2)
    video = [{"image_tensor": torch.rand(1, 3, 5, 64, 64, generator=gen)
              * 2 - 1, "caption": ["a chair"]}]
    prompts = [{"prompt": ["a red chair"]}, {"prompt": ["a blue chair"]}]
    table = torch.randn(8, DIT["text_dim"], generator=gen)

    def embed_text(texts):
        return torch.stack([table[[len(t) % 8, (len(t) + 1) % 8, 3, 4, 5]]
                            for t in texts])
    feat = torch.nn.functional.normalize(torch.randn(1, 16, generator=gen),
                                         dim=-1)
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    seen, snaps = [], []

    def on_metrics(h):
        seen.append(h)
        snaps.append({k: v.detach().clone()
                      for k, v in tvdm.flat_lora(state.lora).items()})
    state, hist = tcli.run(
        state, p["dit"], p["enc"], p["dec"], p["stitched"],
        text_loader=prompts, video_loader=video, embed_text=embed_text,
        reward_loss_fn=p["loss"], scfg=p["scfg"], cfg=cfg, num_steps=2,
        latent_shape=LAT, render_size=56, on_metrics=on_metrics,
        reward_text_fn=lambda prompt: (feat, feat))
    assert state.step == 2 and len(hist) == 2 and seen == hist
    assert hist[0]["num_steps"] == 3                 # step 0: the highest
    for h in hist:
        assert np.isfinite(h["total_loss"]) and h["reward_loss"] != 0
        assert h["grad_norm"] > 0 and not h["skipped"]
        assert "a red chair" in h["rl_prompt"] or \
            "a blue chair" in h["rl_prompt"]
    assert max(float(f["b"].abs().max()) for f in state.lora.values()) > 0
    # EMA: e1 = d0·e0 + (1 − d0)·p1, e2 = d1·e1 + (1 − d1)·p2
    d0, d1 = tema.current_decay(0), tema.current_decay(1)
    assert (d0, d1) == (pytest.approx(0.1), pytest.approx(2 / 11))
    for k, e in state.ema.items():
        e1 = d0 * ema0[k] + (1 - d0) * snaps[0][k]
        torch.testing.assert_close(e, d1 * e1 + (1 - d1) * snaps[1][k],
                                   atol=1e-7, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tcli.run(state, p["dit"], p["enc"], p["dec"], p["stitched"],
                 text_loader=prompts, video_loader=video,
                 embed_text=embed_text, reward_loss_fn=None, scfg=p["scfg"],
                 cfg=cfg, num_steps=3, save_path="x")
