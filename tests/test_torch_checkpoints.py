"""Checkpoints and resume of the port's two trainers
(`vist3a_tpu_torch/io/checkpoints.py`, `cli/train_stitching.py::run`,
`cli/train_vdm.py::run`).

Against the JAX package (`vist3a_tpu/io/checkpoints.py`, the parity target
of `tests/test_ema_checkpoints.py`), at one state carried over to the port
with `convert`, exact in fp32:
  * the stitching epoch's exported set: the port's
    `stitched_model_epoch_N.pt` against what JAX's
    `save_stitching_checkpoint` writes (`stitched_model_state`, read back
    from its orbax folder) — the same LoRA factors and the same trained
    model tensors (stitch conv, tokens, the LoRA sites' biases), the
    port's model set made by its own `init_train_state`;
  * a VDM `checkpoint-N`: what the port's `train_vdm.save` writes (lora,
    lora_ema, ema_shadow, the AdamW moments and count, meta's step)
    against what JAX's `run` hands `save_vdm_checkpoint` (its folders read
    back);
  * `latest_checkpoint` on folders both accept.
And the port's own claim, stronger than JAX's round trip: on the CPU, a
run of n steps equals, bit for bit, a run of k steps that saves, then a
fresh state loaded from that save that takes the n − k steps left — the
trainables, both AdamW moments, the step count, the EMA shadow, the
metrics of every step.  Both trainers at the tiny configs of their tests
(`test_torch_stitch_train.py`: the tiny stitched decoder, LoRA r2 α4,
21-frame clips; `test_torch_vdm.py`: DiT dim 48, VAE base 8, CLIP width
32, 2-step rollouts rendered at 56²), random weights from the port's
`init` on seeds.  The VDM run takes the reward branch, so the prompt
augmentation draws from the host generator whose position the checkpoint
carries.  Also the round trips of the three schemes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import CAMERA_BIAS, _configs
from vist3a_tpu.io import checkpoints as jckpt
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import wan_dit as jdit
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu.train import ema as jema
from vist3a_tpu.train import stitching as jst
from vist3a_tpu.train import vdm as jvdm
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.cli import train_stitching as tcli
from vist3a_tpu_torch.cli import train_vdm as vcli
from vist3a_tpu_torch.io import checkpoints as ckpt
from vist3a_tpu_torch.nn import clip as tclip
from vist3a_tpu_torch.nn import wan_dit as tdit
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.nn.encoder import Encoder
from vist3a_tpu_torch.nn.layers import build_random
from vist3a_tpu_torch.stitch import chopped_anysplat as tca
from vist3a_tpu_torch.train import reward as trew
from vist3a_tpu_torch.train import stitching as tst
from vist3a_tpu_torch.train import vdm as tvdm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a == b


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_sites(lora: dict) -> dict:
    """{site: {"a", "b"}} → {"<site>.a": ..., "<site>.b": ...}."""
    return {f"{s}.{k}": f[k] for s, f in lora.items() for k in ("a", "b")}


def _optimizer_state(opt):
    return ckpt._detached({str(i): s for i, s in
                           enumerate(opt.state_dict()["state"].values())})


# --------------------------------------------------------------------------- #
# stitching distillation                                                      #
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def stitch_setup():
    _, tcfg = _configs()
    gen = torch.Generator().manual_seed(0)
    teacher = build_random(lambda: Encoder(tcfg.encoder, vit_start=0), gen,
                           "cpu", torch.float32)
    teacher.camera_head.pose_branch.fc2.bias.copy_(torch.from_numpy(
        CAMERA_BIAS))
    params = {"encoder": teacher,
              "stitch_conv": build_random(lambda: tca.init_stitch_conv(tcfg),
                                          gen, "cpu", torch.float32),
              "vae": tvae.init_encoder(tvae.WanVAEConfig(base_dim=8), gen,
                                       device="cpu")}
    clip = torch.rand(1, 3, 21, 56, 56, generator=gen) * 2 - 1
    batch = {"vae_image_tensor": clip, "feedforward_image_tensor": clip}
    cfg = tst.StitchTrainConfig(lora_spec="r2,a4,d0.0,f0", warmup_steps=1,
                                total_steps=6)
    return tcfg, params, batch, cfg


def test_stitching_resume_equals_an_unbroken_run(stitch_setup, tmp_path):
    """3 epochs of one step, against 1 epoch saved and 2 more resumed; seed
    6 draws 9, 13 and 9 views."""
    tcfg, params, batch, cfg = stitch_setup
    kw = dict(train_cfg=cfg, seed=6, log_every=1)
    whole, hist = tcli.run(params, tcfg, [batch], num_epochs=3, **kw)
    tcli.run(params, tcfg, [batch], num_epochs=1, save_path=tmp_path, **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "resume_checkpoint.pt", "stitched_model_epoch_0.pt"]
    resumed, rest = tcli.run(params, tcfg, [batch], num_epochs=3,
                             resume_path=tmp_path, save_path=tmp_path, **kw)
    assert [h["step"] for h in rest] == [1, 2] and resumed.step == 3
    assert rest == hist[1:]                 # every metric, bit for bit
    _equal_trees(ckpt._detached(resumed.trainable),
                 ckpt._detached(whole.trainable))
    _equal_trees(_optimizer_state(resumed.optimizer),
                 _optimizer_state(whole.optimizer))
    # the exported set of the last epoch is the run's trainables
    art = torch.load(tmp_path / "stitched_model_epoch_2.pt",
                     weights_only=True)
    _equal_trees(art, ckpt.stitched_model_state(whole.trainable))
    assert "stitch_conv.weight" in art["model"] \
        and "encoder.vit.cls_token" in art["model"]


# --------------------------------------------------------------------------- #
# VDM fine-tuning                                                             #
# --------------------------------------------------------------------------- #
DIT = dict(dim=48, ffn_dim=96, num_layers=2, num_heads=4, freq_dim=32,
           text_dim=24)
CL = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
          patch_size=8, image_size=32, projection_dim=16)


@pytest.fixture(scope="module")
def vdm_setup():
    _, scfg = _configs()
    gen = torch.Generator().manual_seed(1)
    vcfg = tvae.WanVAEConfig(base_dim=8, z_dim=16, num_res_blocks=1)
    stitched = tca.init(scfg, gen, "cpu")
    stitched.encoder.camera_head.pose_branch.fc2.bias.copy_(
        torch.from_numpy(CAMERA_BIAS))
    ccfg = tclip.CLIPVisionConfig(**CL)
    models = dict(
        dit=tdit.init(tdit.WanDiTConfig(**DIT), gen, "cpu"),
        enc=tvae.init_encoder(vcfg, gen, device="cpu"),
        dec=tvae.init_decoder(vcfg, gen, device="cpu"),
        stitched=stitched,
        loss=trew.make_loss_fn(
            tclip.init(ccfg, gen, "cpu"), tclip.init(ccfg, gen, "cpu"),
            logit_scale=100.0,
            cfg=trew.RewardConfig(pick_cfg=ccfg, pe_cfg=ccfg)))
    video = [{"image_tensor": torch.rand(1, 3, 5, 64, 64, generator=gen)
              * 2 - 1, "caption": ["a chair"]}]
    prompts = [{"prompt": ["a red chair"]}, {"prompt": ["a blue chair"]}]
    table = torch.randn(8, DIT["text_dim"], generator=gen)

    def embed_text(texts):
        return torch.stack([table[[len(t) % 8, (len(t) + 1) % 8, 3, 4, 5]]
                            for t in texts])
    feat = torch.nn.functional.normalize(torch.randn(1, 16, generator=gen),
                                         dim=-1)
    cfg = tvdm.VDMTrainConfig(enable_rl=True, rollout_steps_low=2,
                              rollout_steps_high=2)

    def run(state, num_steps, **kw):
        return vcli.run(
            state, models["dit"], models["enc"], models["dec"],
            models["stitched"], text_loader=prompts, video_loader=video,
            embed_text=embed_text, reward_loss_fn=models["loss"],
            scfg=scfg, cfg=cfg, num_steps=num_steps, seed=3,
            latent_shape=(1, 16, 2, 8, 8), render_size=56,
            reward_text_fn=lambda prompt: (feat, feat), **kw)

    def fresh():
        return tvdm.init_train_state(torch.Generator().manual_seed(2),
                                     models["dit"], cfg)
    return run, fresh


def test_vdm_resume_equals_an_unbroken_run(vdm_setup, tmp_path):
    """2 steps saving after each (save_freq 1), against a fresh state
    resumed from `checkpoint-1` taking the second: the second prompt, the
    generator's next camera augmentation, the same update.  Resumed from
    the save folder, the latest save (`checkpoint-2`) is the end state."""
    run, fresh = vdm_setup
    whole, hist = run(fresh(), 2, save_path=tmp_path, save_freq=1)
    assert sorted(p.name for p in tmp_path.glob("checkpoint-*")) == [
        "checkpoint-1", "checkpoint-2"]
    resumed, rest = run(fresh(), 2, resume_path=tmp_path / "checkpoint-1")
    assert rest == hist[1:] and rest[0]["prompt"] == "a blue chair"
    last, none = run(fresh(), 2, resume_path=tmp_path)
    assert none == [] and resumed.step == last.step == 2
    for state in (resumed, last):
        _equal_trees(tvdm.flat_lora(state.lora), tvdm.flat_lora(whole.lora))
        _equal_trees(state.ema, whole.ema)
        _equal_trees(_optimizer_state(state.optimizer),
                     _optimizer_state(whole.optimizer))


# --------------------------------------------------------------------------- #
# round trips                                                                 #
# --------------------------------------------------------------------------- #
def test_vdm_checkpoint_roundtrip_and_latest(tmp_path):
    assert ckpt.latest_checkpoint(tmp_path / "none") is None
    lora = {"blocks.0.attn1.q.a": torch.ones(4, 2),
            "blocks.0.attn1.q.b": torch.zeros(2, 4)}
    opt = {"state": {0: {"step": torch.tensor(11.0),
                         "exp_avg": torch.full((4, 2), 0.5)}},
           "param_groups": [{"lr": 1e-4, "params": [0]}]}
    shadow = {k: v + 1.0 for k, v in lora.items()}
    for step in (100, 200, 30):
        ckpt.save_vdm_checkpoint(tmp_path, step, lora=lora, lora_ema=shadow,
                                 opt_state=opt, ema_shadow=shadow,
                                 meta={"step": step, "epoch": 1})
    (tmp_path / ".checkpoint-900.tmp-1").mkdir()    # an unfinished save
    (tmp_path / "checkpoint-notes").mkdir()
    latest = ckpt.latest_checkpoint(tmp_path)
    assert latest.endswith("checkpoint-200")
    # saving the same step again replaces it whole
    ckpt.save_vdm_checkpoint(tmp_path, 200, lora=shadow, lora_ema=shadow,
                             opt_state=opt, ema_shadow=shadow,
                             meta={"step": 200})
    l2, le2, o2, s2, meta = ckpt.load_vdm_checkpoint(latest)
    assert meta == {"step": 200}
    _equal_trees(l2, shadow)
    _equal_trees(o2, opt)
    _equal_trees(s2, shadow)
    assert json.loads((tmp_path / "checkpoint-100" / "meta.json")
                      .read_text())["epoch"] == 1


def test_search_artifact_roundtrip(tmp_path):
    tree = {"kernel": np.random.default_rng(0).standard_normal((8, 4, 3)),
            "bias": np.zeros(8)}
    path = tmp_path / "state_dict_enc_blocks_2.npz"
    ckpt.save_search_artifact(path, tree)
    back = ckpt.load_search_artifact(path)
    np.testing.assert_array_equal(back["kernel"], tree["kernel"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]


# --------------------------------------------------------------------------- #
# against the JAX package                                                     #
# --------------------------------------------------------------------------- #
def _random_b(lora, seed):
    """The LoRA tree with every B factor drawn nonzero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if getattr(path[-1], "key", None) == "b" else x, lora)


def test_stitching_export_matches_jax(tmp_path):
    """One initial state in both packages (the JAX init's encoder and stitch
    conv carried over, the JAX LoRA factors with B random copied into the
    port's): the port's per-epoch `stitched_model_epoch_0.pt` holds exactly
    JAX's `stitched_model_epoch_0` converted — every key, every value in
    fp32.  The model tensors are not copied: the port's `init_train_state`
    makes them from the teacher."""
    jcfg, tcfg = _configs()
    k_chop = tcfg.stitch_layer_index
    params = {"encoder": jenc.init(jax.random.key(0), jcfg.encoder),
              "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg)}
    lora_spec = "r2,a4,d0.0,f0"
    jstate, _ = jst.init_train_state(
        jax.random.key(3), params, jst.StitchTrainConfig(lora_spec=lora_spec))
    jstate = jstate._replace(
        step=jnp.asarray(4, jnp.int32),
        trainable={**jstate.trainable,
                   "lora": _random_b(jstate.trainable["lora"], 7)})
    jckpt.save_stitching_checkpoint(tmp_path / "jax", 0, jstate)
    want_tree = jckpt.stitched_model_state(jstate.trainable)
    want = convert.trainable_from_jax(_np(jckpt._restore(
        tmp_path / "jax" / "stitched_model_epoch_0", want_tree)), k_chop)

    teacher = Encoder(tcfg.encoder, vit_start=0)
    convert.load_jax_encoder_params(teacher, _np(params["encoder"]))
    stitch_conv = tca.init_stitch_conv(tcfg)
    stitch_conv.load_state_dict({
        k.split(".", 1)[1]: v for k, v in convert.from_jax_params(
            _np({"stitch_conv": params["stitch_conv"]})).items()})
    state, _ = tst.init_train_state(
        torch.Generator().manual_seed(0), teacher.requires_grad_(False),
        stitch_conv, tcfg, tst.StitchTrainConfig(lora_spec=lora_spec))
    with torch.no_grad():
        for site, f in state.trainable["lora"].items():
            for k in ("a", "b"):
                f[k].copy_(want["lora"][site][k])
    state.step = 4
    ckpt.save_stitching_checkpoint(tmp_path / "port", 0, state)
    got = torch.load(tmp_path / "port" / "stitched_model_epoch_0.pt",
                     weights_only=True)
    assert got.keys() == {"lora", "model"}
    assert len(got["lora"]) > 10 and "stitch_conv.weight" in got["model"] \
        and "encoder.vit.register_tokens" in got["model"]
    want = {"lora": want["lora"], "model": want["model"]}
    for part in ("lora", "model"):
        g = _flat_sites(got[part]) if part == "lora" else got[part]
        w = _flat_sites(want[part]) if part == "lora" else want[part]
        assert g.keys() == w.keys(), part
        for k, v in w.items():
            assert g[k].dtype == v.dtype == torch.float32, k
            assert torch.equal(g[k], v), k
    resume = torch.load(tmp_path / "port" / "resume_checkpoint.pt",
                        weights_only=True)
    assert resume["epoch"] == 0 and resume["step"] == int(jstate.step)


def test_vdm_save_matches_jax(tmp_path):
    """One VDM state in both packages: the JAX init's LoRA with B random, an
    EMA shadow apart from it, AdamW moments from one update of random
    gradients, step 5, carried to the port by `convert.vdm_state_from_jax`.
    What JAX's `run` hands `save_vdm_checkpoint` (read back from its
    folders) against what the port's `train_vdm.save` writes: lora,
    lora_ema (the shadow cast like the LoRA), ema_shadow, the AdamW first
    and second moments and count, and meta's step — exact in fp32."""
    jdcfg = jdit.WanDiTConfig(**DIT, attn_impl="xla")
    dparams = jdit.init(jax.random.key(0), jdcfg)
    jcfg = jvdm.VDMTrainConfig()
    state = jvdm.init_train_state(jax.random.key(1), dparams, jcfg)
    lora = _random_b(state.lora, 5)
    grads = _random_b(jax.tree_util.tree_map(jnp.zeros_like, lora), 6)
    grads = jax.tree_util.tree_map(lambda g: g + 0.01, grads)
    _, opt_state = jvdm.build_optimizer(jcfg).update(grads, state.opt_state,
                                                     lora)
    ema = jax.tree_util.tree_map(lambda x: 0.5 * x + 0.25, lora)
    jstate = state._replace(step=jnp.asarray(5, jnp.int32), lora=lora,
                            opt_state=opt_state, ema=ema)
    step = int(jstate.step)
    lora_ema = jema.ema_params_like(jstate.ema, jstate.lora)
    jckpt.save_vdm_checkpoint(
        tmp_path / "jax", step, lora=jstate.lora, lora_ema=lora_ema,
        opt_state=jstate.opt_state, ema_shadow=jstate.ema,
        meta={"step": step})
    jroot = tmp_path / "jax" / f"checkpoint-{step}"
    want = {name: _flat_sites(convert.dit_lora_from_jax(_np(jckpt._restore(
        jroot / name, tree))))
        for name, tree in (("lora", jstate.lora), ("lora_ema", lora_ema),
                           ("ema_shadow", jstate.ema))}
    adam = convert._adam_state(_np(jckpt._restore(jroot / "optim",
                                                  jstate.opt_state)))
    mu = _flat_sites(convert.dit_lora_from_jax(adam.mu))
    nu = _flat_sites(convert.dit_lora_from_jax(adam.nu))

    dit = convert.load_jax_dit_params(tdit.WanDiT(tdit.WanDiTConfig(**DIT)),
                                      _np(dparams)).requires_grad_(False)
    pstate = tvdm.init_train_state(torch.Generator().manual_seed(0), dit,
                                   tvdm.VDMTrainConfig())
    convert.vdm_state_from_jax(_np(jstate), pstate)
    path = vcli.save(tmp_path / "port", pstate, np.random.default_rng(0))
    assert path.endswith(jroot.name)
    lo, le, opt, shadow, meta = ckpt.load_vdm_checkpoint(path)
    assert meta["step"] == json.loads(
        (jroot / "meta.json").read_text())["step"] == step
    assert len(want["lora"]) == 16 * DIT["num_layers"]
    for name, got in (("lora", lo), ("lora_ema", le), ("ema_shadow", shadow)):
        assert got.keys() == want[name].keys(), name
        for k, w in want[name].items():
            assert got[k].dtype == w.dtype == torch.float32, (name, k)
            assert torch.equal(got[k], w), (name, k)
    assert not torch.equal(lo[k], shadow[k])
    names = list(lo)                 # the optimizer's parameter order
    assert [len(g["params"]) for g in opt["param_groups"]] == [len(names)]
    for i, k in enumerate(names):
        s = opt["state"][i]
        assert float(s["step"]) == float(np.asarray(adam.count)) == 1.0
        assert torch.equal(s["exp_avg"], mu[k]), k
        assert torch.equal(s["exp_avg_sq"], nu[k]), k
        assert float(s["exp_avg_sq"].abs().max()) > 0, k


@pytest.mark.parametrize("layout", [
    None, [], ["checkpoint-7"], ["checkpoint-100", "checkpoint-200",
                                 "checkpoint-30"],
    ["checkpoint-9", "checkpoint-10", "images", "history.jsonl",
     "checkpoint-400.json"]])
def test_latest_checkpoint_matches_jax(tmp_path, layout):
    """`latest_checkpoint` of the port and of JAX on one folder: absent,
    empty, one save, several (numeric, not lexical, order), saves beside
    other folders and files (a name ending in ".json" is a file)."""
    root = tmp_path / "saves"
    if layout is not None:
        root.mkdir()
        for name in layout:
            if "." in name:
                (root / name).write_text("{}")
            else:
                (root / name).mkdir()
    got = ckpt.latest_checkpoint(root)
    assert got == jckpt.latest_checkpoint(root)
    assert (got is None) == (not any(n.startswith("checkpoint-")
                                     and "." not in n
                                     for n in layout or []))
