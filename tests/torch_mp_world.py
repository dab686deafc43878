"""The worker of `test_torch_multiprocess.py`: one rank of a spawned 2×2
gloo world (data 2, model 2) on the CPU.

    RANK=r WORLD_SIZE=4 python tests/torch_mp_world.py WORKDIR

Each rank joins the group through `core/distributed.py::setup_dist` with a
`file://` rendezvous in WORKDIR, then runs every scenario of `SCENARIOS` in
order and writes each one's result to WORKDIR/<name>.r<rank>.pt (a
traceback under "error" where it raised).  First, each of ranks 0-2
computes one world-1 baseline without collectives, so the three run at
once.  Imports torch and the port only; the parent test holds the JAX side
and writes WORKDIR/inputs.pt (the tiny DiT's weights, converted from the
JAX package's `init`, and the inputs of the forward and the denoise).
"""

from __future__ import annotations

import datetime
import sys
import traceback
import zlib
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vist3a_tpu_torch.cli import train_stitching as stitch_cli  # noqa: E402
from vist3a_tpu_torch.cli import train_vdm as vdm_cli  # noqa: E402
from vist3a_tpu_torch.core import distributed  # noqa: E402
from vist3a_tpu_torch.core import mesh as mesh_mod  # noqa: E402
from vist3a_tpu_torch.data.loader import ShardedSampler  # noqa: E402
from vist3a_tpu_torch.io import checkpoints as ckpt  # noqa: E402
from vist3a_tpu_torch.nn import aggregator as tagg  # noqa: E402
from vist3a_tpu_torch.nn import clip as tclip  # noqa: E402
from vist3a_tpu_torch.nn import encoder as tenc  # noqa: E402
from vist3a_tpu_torch.nn import heads as th  # noqa: E402
from vist3a_tpu_torch.nn import qwen_vl  # noqa: E402
from vist3a_tpu_torch.nn import vit as tvit  # noqa: E402
from vist3a_tpu_torch.nn import wan_dit, wan_vae  # noqa: E402
from vist3a_tpu_torch.nn.layers import build_random  # noqa: E402
from vist3a_tpu_torch.pipelines import t23d  # noqa: E402
from vist3a_tpu_torch.stitch import chopped_anysplat as tca  # noqa: E402
from vist3a_tpu_torch.train import reward as trew  # noqa: E402
from vist3a_tpu_torch.train import stitching as tst  # noqa: E402
from vist3a_tpu_torch.train import vdm as tvdm  # noqa: E402

DATA, MODEL = 2, 2
WORLD = DATA * MODEL
TIMEOUT = datetime.timedelta(seconds=120)
# the tiny configs of the JAX mesh tests (`tests/test_mesh_cli.py`,
# `tests/test_vdm_training.py`, `tests/test_torch_slice.py`)
D = 32
SPEC = f"conv3d_k5x3x3_o{D}_s1x2x2_p2x1x1"
CAMERA_BIAS = (0.05, -0.05, 0.5, 0.02, 0.03, 0.01, 0.25, 0.2, 0.2)
DIT = dict(dim=48, ffn_dim=96, num_layers=2, num_heads=4, freq_dim=32,
           text_dim=24)
VAE = dict(base_dim=8, z_dim=16, num_res_blocks=1)
CLIP = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
            patch_size=8, image_size=32, projection_dim=16)
TEXT = dict(vocab_size=128, hidden_size=48, intermediate_size=96,
            num_layers=3, num_heads=4, num_kv_heads=2, rope_theta=1e6,
            mrope_section=(2, 2, 2), rms_eps=1e-6, tie_embeddings=False,
            image_token_id=120, video_token_id=121,
            vision_start_token_id=122, eos_token_ids=())
STITCH_VIEWS, STITCH_HW, STITCH_STEPS = 5, 56, 2
VDM_FRAMES, VDM_HW, VDM_STEPS = 5, 64, 2
LAT = (1, 16, 2, 8, 8)
DENOISE = dict(width=64, height=64, num_frames=5, num_inference_steps=4)
SAMPLES = 10


def stitched_config() -> tca.StitchedConfig:
    return tca.StitchedConfig(
        encoder=tenc.EncoderConfig(
            vit=tvit.ViTConfig(img_size=56, embed_dim=D, depth=4,
                               num_heads=2),
            agg=tagg.AggregatorConfig(embed_dim=D, depth=4, num_heads=2,
                                      taps=(0, 1, 2, 3)),
            camera=th.CameraHeadConfig(dim_in=2 * D, trunk_depth=1,
                                       num_heads=2),
            depth=th.DPTConfig(dim_in=2 * D, features=16,
                               out_channels=(8, 16, 16, 16),
                               head2_features=8),
            gs=th.GSHeadConfig(dim_in=2 * D, features=16,
                               out_channels=(8, 16, 16, 16), output_dim=84,
                               head2_features=16, pos_embed=False)),
        stitch_layer_index=2, conv_spec=SPEC,
        vae=wan_vae.WanVAEConfig(**VAE))


def _encoder(cfg, gen):
    enc = build_random(lambda: tenc.Encoder(cfg), gen, "cpu", torch.float32)
    with torch.no_grad():
        enc.camera_head.pose_branch.fc2.bias.copy_(torch.tensor(CAMERA_BIAS))
    return enc.requires_grad_(False)


# --------------------------------------------------------------------------- #
# distillation                                                                #
# --------------------------------------------------------------------------- #
def stitch_params(scfg):
    gen = torch.Generator().manual_seed(0)
    return {"encoder": _encoder(scfg.encoder, gen),
            "stitch_conv": build_random(lambda: tca.init_stitch_conv(scfg),
                                        gen, "cpu", torch.float32),
            "vae": wan_vae.init_encoder(wan_vae.WanVAEConfig(**VAE), gen,
                                        device="cpu").requires_grad_(False)}


def stitch_batches(rows: slice) -> list:
    """STITCH_STEPS batches of the global batch (DATA clips), `rows` of
    each."""
    rng = np.random.default_rng(5)
    shape = (DATA, 3, STITCH_VIEWS, STITCH_HW, STITCH_HW)
    out = []
    for _ in range(STITCH_STEPS):
        vae = rng.uniform(-1, 1, shape).astype(np.float32)
        ff = rng.uniform(-1, 1, shape).astype(np.float32)
        out.append({"vae_image_tensor": vae[rows],
                    "feedforward_image_tensor": ff[rows]})
    return out


def run_distillation(mesh, save_path=None) -> dict:
    tst.VIEW_COUNTS = (STITCH_VIEWS,)
    scfg = stitched_config()
    rows = slice(None) if mesh is None else \
        slice(mesh.data_index, mesh.data_index + 1)
    train_cfg = tst.StitchTrainConfig(lora_spec="r2,a4,d0.0,f0",
                                      warmup_steps=1, total_steps=8)
    params = stitch_params(scfg)
    state0, _ = tst.init_train_state(torch.Generator("cpu").manual_seed(3),
                                     params["encoder"],
                                     params["stitch_conv"], scfg, train_cfg)
    state, hist = stitch_cli.run(
        params, scfg, stitch_batches(rows), None, train_cfg=train_cfg,
        num_epochs=1, seed=3, log_every=1, save_path=save_path, mesh=mesh)
    return {"history": hist,
            "before": _flat_trainable(state0.trainable),
            "after": _flat_trainable(state.trainable)}


def _flat_trainable(trainable: dict) -> dict:
    out = {f"model.{k}": v.detach().clone()
           for k, v in trainable["model"].items()}
    out.update((f"lora.{s}.{k}", f[k].detach().clone())
               for s, f in trainable["lora"].items() for k in ("a", "b"))
    return out


# --------------------------------------------------------------------------- #
# VDM tuning                                                                  #
# --------------------------------------------------------------------------- #
def embed_text(prompts):
    """Text embeddings (B, 5, text_dim) drawn from a seed of each prompt."""
    return torch.stack([torch.randn(
        5, DIT["text_dim"], generator=torch.Generator().manual_seed(
            zlib.crc32(p.encode()))) for p in prompts])


def vdm_models(rl: bool) -> dict:
    gen = torch.Generator().manual_seed(0)
    vcfg = wan_vae.WanVAEConfig(**VAE)
    out = {"dit": wan_dit.init(wan_dit.WanDiTConfig(**DIT), gen, "cpu"),
           "enc": wan_vae.init_encoder(vcfg, gen, device="cpu"),
           "dec": wan_vae.init_decoder(vcfg, gen, device="cpu")}
    out["dit"].requires_grad_(False)
    if rl:
        scfg = stitched_config()
        stitched = build_random(lambda: tca.StitchedDecoder(scfg), gen,
                                "cpu", torch.float32)
        with torch.no_grad():
            stitched.encoder.camera_head.pose_branch.fc2.bias.copy_(
                torch.tensor(CAMERA_BIAS))
        ccfg = tclip.CLIPVisionConfig(**CLIP)
        pick, pe = (tclip.init(ccfg, torch.Generator().manual_seed(i),
                               "cpu").requires_grad_(False) for i in (4, 5))
        out.update(stitched=stitched.requires_grad_(False), scfg=scfg,
                   loss=trew.make_loss_fn(pick, pe, logit_scale=100.0,
                                          cfg=trew.RewardConfig(
                                              pick_cfg=ccfg, pe_cfg=ccfg)))
    return out


def video_batches(rows: slice, n: int) -> list:
    rng = np.random.default_rng(7)
    shape = (DATA, 3, VDM_FRAMES, VDM_HW, VDM_HW)
    return [{"image_tensor": rng.uniform(-1, 1, shape).astype(
        np.float32)[rows], "caption": [f"clip {i}-{j}" for j in
                                       range(DATA)][rows]} for i in range(n)]


def inference_forward(dit) -> torch.Tensor:
    """The DiT's inference entry (`forward(remat=False)`) on a fixed
    input."""
    gen = torch.Generator().manual_seed(8)
    return wan_dit.forward(
        dit, torch.randn(LAT, generator=gen), torch.full((1,), 500.0),
        torch.randn((1, 5, DIT["text_dim"]), generator=gen))


def run_vdm(mesh, how: str, *, rl: bool = False, num_steps: int = VDM_STEPS,
            save_path=None, save_freq: int = 100, resume_path=None,
            inference_around: bool = False) -> dict:
    """`cli.train_vdm.run` over the tiny models, the DiT placed `how`;
    with `inference_around`, the DiT's inference entry runs before the
    training steps and after them (an FSDP2 buffer gathered without
    gradients must serve a later step with them)."""
    m = vdm_models(rl)
    cfg = tvdm.VDMTrainConfig(enable_rl=rl, rollout_steps_low=3,
                              rollout_steps_high=3)
    state = tvdm.init_train_state(torch.Generator().manual_seed(4),
                                  m["dit"], cfg)
    mesh_mod.place_dit(m["dit"], m["dit"].cfg, mesh, how)
    before = inference_forward(m["dit"]) if inference_around else None
    rows = slice(None) if mesh is None else \
        slice(mesh.data_index, mesh.data_index + 1)
    feat = torch.nn.functional.normalize(
        torch.randn(1, 16, generator=torch.Generator().manual_seed(6)),
        dim=-1)
    state, hist = vdm_cli.run(
        state, m["dit"], m["enc"], m["dec"], m.get("stitched"),
        text_loader=[{"prompt": [f"a scene {i}"]} for i in range(VDM_STEPS)],
        video_loader=video_batches(rows, VDM_STEPS), embed_text=embed_text,
        reward_loss_fn=m.get("loss"), scfg=m.get("scfg"), cfg=cfg,
        num_steps=num_steps, latent_shape=LAT, render_size=56,
        reward_text_fn=(lambda prompt: (feat, feat)) if rl else None,
        save_path=save_path, save_freq=save_freq, resume_path=resume_path,
        mesh=mesh)
    out = {"history": [{k: v for k, v in h.items() if k != "images"}
                       for h in hist],
           "lora": {k: v.detach().clone()
                    for k, v in tvdm.flat_lora(state.lora).items()}}
    if inference_around:
        out["inference"] = (before.clone(),
                            inference_forward(m["dit"]).clone())
    return out


# --------------------------------------------------------------------------- #
# scenarios                                                                   #
# --------------------------------------------------------------------------- #
def scenario_baselines(mesh, workdir: Path) -> dict:
    """Ranks 0-2: one world-1 run each over the concatenated batch."""
    rank = distributed.get_rank()
    if rank == 0:
        return {"distillation": run_distillation(None)}
    if rank == 1:
        return {"vdm": run_vdm(None, "replicated")}
    if rank == 2:
        return {"vdm_rl": run_vdm(None, "replicated", rl=True,
                                  num_steps=1)}
    return {}


def scenario_mesh_errors(mesh, workdir: Path) -> dict:
    out = {}
    for cfg in (mesh_mod.MeshConfig(data=3), mesh_mod.MeshConfig(model=3),
                mesh_mod.MeshConfig(data=2, model=3)):
        try:
            mesh_mod.create_mesh(cfg)
            out[repr(cfg)] = None
        except ValueError as e:
            out[repr(cfg)] = str(e)
    return out


def scenario_sampler(mesh, workdir: Path) -> dict:
    sampler = ShardedSampler(SAMPLES, mesh_mod.data_size(mesh),
                             mesh_mod.data_index(mesh))
    sampler.set_epoch(1)
    return {"indices": sampler.indices().tolist(),
            "data_index": mesh.data_index, "model_index": mesh.model_index}


def scenario_distillation(mesh, workdir: Path) -> dict:
    calls = []
    save = ckpt.save_stitching_checkpoint

    def counted(*a, **k):
        calls.append(a[1])
        return save(*a, **k)
    ckpt.save_stitching_checkpoint = counted
    try:
        out = run_distillation(mesh, save_path=workdir / "stitching")
    finally:
        ckpt.save_stitching_checkpoint = save
    out["saves"] = calls
    out["saved"] = sorted(p.name for p in (workdir / "stitching").iterdir())
    return out


def scenario_vdm(how: str):
    def fn(mesh, workdir: Path) -> dict:
        return run_vdm(mesh, how, inference_around=True)
    return fn


def scenario_vdm_rl(mesh, workdir: Path) -> dict:
    return run_vdm(mesh, "fsdp", rl=True, num_steps=1)


def scenario_tp_forward(mesh, workdir: Path) -> dict:
    inp = torch.load(workdir / "inputs.pt")
    dit = wan_dit.WanDiT(wan_dit.WanDiTConfig(**DIT))
    dit.load_state_dict(inp["dit"])
    mesh_mod.place_dit(dit, dit.cfg, mesh, "tp")
    out = wan_dit.forward(dit, inp["latent"], inp["timestep"], inp["text"])
    return {"out": out.clone(),
            "q_rows": dit.blocks[0].attn1.q.weight.shape[0],
            "o_cols": dit.blocks[0].attn1.o.weight.shape[1]}


def scenario_tp_denoise(mesh, workdir: Path) -> dict:
    inp = torch.load(workdir / "inputs.pt")
    dit = wan_dit.WanDiT(wan_dit.WanDiTConfig(**DIT))
    dit.load_state_dict(inp["dit"])
    mesh_mod.place_dit(dit, dit.cfg, mesh, "tp")
    cfg = t23d.T23DConfig(dit=dit.cfg, **DENOISE)
    lat = t23d.denoise(dit, inp["cond"], inp["uncond"], cfg,
                       latents0=inp["latents0"], device="cpu")
    return {"latents": lat.clone()}


def scenario_judge(mesh, workdir: Path) -> dict:
    cfg = qwen_vl.QwenVLTextConfig(**TEXT)
    model = qwen_vl.text_init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 100, size=(11,)))
    pos = torch.from_numpy(np.tile(np.arange(11), (3, 1)))

    def forward():
        with torch.no_grad():
            x = qwen_vl.embed_tokens(model, ids, None)
            logits, kc, _ = qwen_vl.text_forward(model, x, pos)
            tokens = qwen_vl.greedy_generate(model, ids.numpy(), None,
                                             pos.numpy(), 0,
                                             max_new_tokens=6)
        return logits.clone(), tuple(kc.shape), tokens
    want, want_cache, want_tokens = forward()
    qwen_vl.place_text(model, mesh)
    got, got_cache, got_tokens = forward()
    return {"want": want, "got": got, "want_cache": want_cache,
            "got_cache": got_cache, "want_tokens": want_tokens,
            "got_tokens": got_tokens}


def scenario_resume(mesh, workdir: Path) -> dict:
    calls = []
    save = ckpt.save_vdm_checkpoint

    def counted(*a, **k):
        calls.append(a[1])
        return save(*a, **k)
    ckpt.save_vdm_checkpoint = counted
    try:
        unbroken = run_vdm(mesh, "tp_fsdp", save_path=workdir / "unbroken",
                           save_freq=1)
        run_vdm(mesh, "tp_fsdp", num_steps=1, save_path=workdir / "broken",
                save_freq=1)
        resumed = run_vdm(mesh, "tp_fsdp",
                          resume_path=workdir / "broken" / "checkpoint-1")
    finally:
        ckpt.save_vdm_checkpoint = save
    return {"unbroken": unbroken, "resumed": resumed, "saves": calls,
            "history_file": (workdir / "unbroken" / "history.jsonl"
                             ).is_file()}


SCENARIOS = {
    "baselines": scenario_baselines,
    "mesh_errors": scenario_mesh_errors,
    "sampler": scenario_sampler,
    "distillation": scenario_distillation,
    **{f"vdm_{how}": scenario_vdm(how) for how in mesh_mod.DIT_SHARDINGS},
    "vdm_rl": scenario_vdm_rl,
    "tp_forward": scenario_tp_forward,
    "tp_denoise": scenario_tp_denoise,
    "judge": scenario_judge,
    "resume": scenario_resume,
}


def main(workdir: str) -> None:
    torch.set_num_threads(1)
    workdir = Path(workdir)
    started = distributed.setup_dist(
        "cpu", init_method=f"file://{workdir / 'rendezvous'}",
        timeout=TIMEOUT)
    assert started and distributed.get_world_size() == WORLD
    rank = distributed.get_rank()
    mesh = mesh_mod.create_mesh(mesh_mod.MeshConfig(data=DATA, model=MODEL))
    try:
        for name, fn in SCENARIOS.items():
            try:
                res = fn(mesh, workdir)
            except Exception:  # noqa: BLE001 — the parent's test fails on it
                res = {"error": traceback.format_exc()}
            torch.save(res, workdir / f"{name}.r{rank}.pt")
            distributed.barrier()
    finally:
        distributed.cleanup()


if __name__ == "__main__":
    main(sys.argv[1])
