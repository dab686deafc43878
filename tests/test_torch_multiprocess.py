"""The port's multi-GPU layer in a spawned 2×2 gloo world on the CPU.

`core/distributed.py`, `core/mesh.py` and the placements of the DiT and the
judge, driven through the trainers' and the pipeline's own loops: four
processes (`tests/torch_mp_world.py`, one torch thread each) join one group
through `setup_dist` with a `file://` rendezvous in the test's temporary
folder (so parallel test workers never share a port) and a 120 s
collective timeout, lay the (data 2, model 2) mesh and run every scenario
once for the whole module; each scenario writes its result to a file, and
each is its own test here.  The world is joined under `DEADLINE`: a hung
collective kills the children and fails the tests, not the suite.

Limits (JAX's for the same comparisons, `tests/test_mesh_cli.py`,
`tests/test_wan_dit.py:106-124`, `tests/test_qwen_vl.py:193-214`):
  * DDP distillation and VDM SFT under every placement, world 4 against
    world 1 over the concatenated batch (ranks 0-2 compute those with no
    collectives): the losses within rel 1e-4; the LoRA factors after the
    VDM steps within 1e-4 of their largest travel; the distillation's
    trainables within 1e-3 of it (measured ≤ 4.8e-4, 6 of 67,301 elements
    above 1e-4: Adam divides each gradient by its own RMS, so where the
    DDP mean's rounding moves a near-cancelling gradient, it moves the
    update by a share of lr; the gradient norms agree to 7e-8);
  * the TP DiT forward against JAX's `wan_dit.forward` on the same
    converted weights, rtol / atol 1e-5; the TP denoise against JAX's
    `t23d.denoise(mesh=...)` with the same `latents0`, 2e-4;
  * the judge's TP text forward against the replicated one, 2e-5.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_world as W
from vist3a_tpu.core import mesh as jmesh
from vist3a_tpu.nn import wan_dit as jdit
from vist3a_tpu.pipelines import t23d as jt23d
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import wan_dit as tdit

DEADLINE = 300.0      # seconds for the whole world, start to exit
WORKER = Path(__file__).with_name("torch_mp_world.py")
LOSS_RTOL = 1e-4
TRAVEL_SHARE = 1e-4
DISTILL_TRAVEL_SHARE = 1e-3
FWD_TOL = 1e-5
DENOISE_TOL = 2e-4
JUDGE_TOL = 2e-5


def _jax_dit():
    cfg = jdit.WanDiTConfig(**W.DIT, attn_impl="xla")
    return cfg, jax.tree_util.tree_map(np.asarray,
                                       jdit.init(jax.random.key(0), cfg))


def _inputs(params) -> dict:
    rng = np.random.default_rng(11)
    model = convert.load_jax_dit_params(tdit.WanDiT(tdit.WanDiTConfig(
        **W.DIT)), params)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    return {"dit": model.state_dict(),
            "latent": t(rng.standard_normal((2, 16, 3, 8, 8),
                                            dtype=np.float32)),
            "timestep": t(np.array([999.0, 317.5], np.float32)),
            "text": t(rng.standard_normal((2, 7, W.DIT["text_dim"]),
                                          dtype=np.float32)),
            "cond": t(rng.standard_normal((1, 14, W.DIT["text_dim"]),
                                          dtype=np.float32)),
            "uncond": t(rng.standard_normal((1, 14, W.DIT["text_dim"]),
                                            dtype=np.float32)),
            "latents0": t(rng.standard_normal((1, 16, 2, 8, 8),
                                              dtype=np.float32))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world once; returns (workdir, seconds, the inputs, the
    JAX DiT's (cfg, params))."""
    workdir = tmp_path_factory.mktemp("torch_mp_world")
    jcfg, jparams = _jax_dit()
    inputs = _inputs(jparams)
    torch.save(inputs, workdir / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env.update(WORLD_SIZE=str(W.WORLD), OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(workdir)],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(W.WORLD)]
    logs = []
    try:
        for p in procs:
            left = max(DEADLINE - (time.monotonic() - t0), 1.0)
            out, _ = p.communicate(timeout=left)
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"the spawned world passed its {DEADLINE} s deadline")
    seconds = time.monotonic() - t0
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode]
    assert not bad, bad
    return workdir, seconds, inputs, (jcfg, jparams)


def _result(world, name: str, rank: int = 0) -> dict:
    res = torch.load(world[0] / f"{name}.r{rank}.pt", weights_only=False)
    assert "error" not in res, res["error"]
    return res


def _baseline(world, key: str) -> dict:
    rank = {"distillation": 0, "vdm": 1, "vdm_rl": 2}[key]
    return _result(world, "baselines", rank)[key]


def _losses_match(got: list, want: list, keys) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in keys:
            assert np.isfinite(g[k])
            assert g[k] == pytest.approx(w[k], rel=LOSS_RTOL), (k, g, w)


def _within_travel(got: dict, want: dict, before: dict | None,
                   share: float = TRAVEL_SHARE) -> None:
    """Every tensor of `got` within `share` of the largest distance any of
    `want`'s elements travelled from `before` (or from zero)."""
    assert got.keys() == want.keys()
    travel = max(float((w - (before[k] if before else 0)).abs().max())
                 for k, w in want.items())
    assert travel > 0
    for k in got:
        assert float((got[k] - want[k]).abs().max()) <= share * travel, k


def test_world_ran_within_its_budget(world):
    """The spawned world, all of its scenarios included, well inside the
    deadline (the seconds are reported in CHANGES.md)."""
    print(f"spawned world: {world[1]:.1f} s")
    assert world[1] < DEADLINE


def test_mismatched_mesh_raises_on_every_rank(world):
    for r in range(W.WORLD):
        res = _result(world, "mesh_errors", r)
        assert res and all(msg is not None and "does not match 4 devices"
                           in msg for msg in res.values()), (r, res)


def test_sampler_splits_by_data_index(world):
    """Model peers (adjacent ranks) get the same indices; the data ranks'
    shares are disjoint and cover the samples.  A split by global rank, as
    before the mesh, fails the first."""
    res = [_result(world, "sampler", r) for r in range(W.WORLD)]
    assert [(x["data_index"], x["model_index"]) for x in res] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert res[0]["indices"] == res[1]["indices"]
    assert res[2]["indices"] == res[3]["indices"]
    a, b = set(res[0]["indices"]), set(res[2]["indices"])
    assert not a & b and a | b == set(range(W.SAMPLES))


def test_ddp_distillation_matches_world_one(world):
    want = _baseline(world, "distillation")
    keys = [k for k in want["history"][0] if k not in ("epoch", "step",
                                                       "views", "lr")]
    for r in range(W.WORLD):
        got = _result(world, "distillation", r)
        _losses_match(got["history"], want["history"], keys)
        _within_travel(got["after"], want["after"], want["before"],
                       DISTILL_TRAVEL_SHARE)


@pytest.mark.parametrize("how", ["fsdp", "tp", "tp_fsdp", "replicated"])
def test_vdm_sft_matches_world_one(world, how):
    """Two SFT steps between two calls of the DiT's inference entry (under
    FSDP2 the weights gathered without gradients, then with them, then
    without); the DiT is frozen, so both calls give one output."""
    want = _baseline(world, "vdm")
    for r in range(W.WORLD):
        got = _result(world, f"vdm_{how}", r)
        _losses_match(got["history"], want["history"],
                      ("diffusion_loss", "total_loss", "grad_norm"))
        _within_travel(got["lora"], want["lora"], None)
        before, after = got["inference"]
        assert torch.isfinite(before).all() and torch.equal(before, after)


def test_vdm_rl_step_under_fsdp_matches_world_one(world):
    want = _baseline(world, "vdm_rl")
    assert want["history"][0]["reward_loss"] != 0
    for r in range(W.WORLD):
        got = _result(world, "vdm_rl", r)
        _losses_match(got["history"], want["history"],
                      ("diffusion_loss", "reward_loss", "total_loss",
                       "grad_norm"))


def test_tp_dit_forward_matches_jax(world):
    """Model 2: each rank runs 2 of the 4 heads and 48 of the 96 hidden
    units; the qk-norm's statistic is summed over the pair and each
    row-parallel bias added once, or the output would not be JAX's."""
    jcfg, jparams = world[3]
    inp = world[2]
    want = np.asarray(jdit.forward(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        jnp.asarray(inp["latent"].numpy()),
        jnp.asarray(inp["timestep"].numpy()),
        jnp.asarray(inp["text"].numpy()), jcfg))
    for r in range(W.WORLD):
        got = _result(world, "tp_forward", r)
        assert got["q_rows"] == W.DIT["dim"] // W.MODEL
        assert got["o_cols"] == W.DIT["dim"] // W.MODEL
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_tp_denoise_matches_jax(world, mesh8):
    jcfg, jparams = world[3]
    inp = world[2]
    cfg = jt23d.T23DConfig(dit=jcfg, **W.DENOISE)
    dit = jmesh.place_dit(jax.tree_util.tree_map(jnp.asarray, jparams), jcfg,
                          mesh8, "tp")
    want = np.asarray(jt23d.denoise(
        dit, jnp.asarray(inp["cond"].numpy()),
        jnp.asarray(inp["uncond"].numpy()), cfg,
        latents0=jnp.asarray(inp["latents0"].numpy()), mesh=mesh8))
    for r in range(W.WORLD):
        got = _result(world, "tp_denoise", r)["latents"].numpy()
        np.testing.assert_allclose(got, want, rtol=DENOISE_TOL,
                                   atol=DENOISE_TOL)


def test_judge_tp_forward_matches_replicated(world):
    """The text decoder cut over model 2 (1 of 2 kv heads a rank, its KV
    cache holding only that one) against the replicated forward; greedy
    decoding picks the same tokens."""
    for r in range(W.WORLD):
        res = _result(world, "judge", r)
        np.testing.assert_allclose(res["got"].numpy(), res["want"].numpy(),
                                   rtol=JUDGE_TOL, atol=JUDGE_TOL)
        assert res["want_cache"][2] == 2 and res["got_cache"][2] == 1
        assert res["got_tokens"] == res["want_tokens"]


def test_resume_under_the_mesh_matches_an_unbroken_run(world):
    for r in range(W.WORLD):
        res = _result(world, "resume", r)
        assert res["resumed"]["history"][0]["step"] == 2
        _within_travel(res["resumed"]["lora"], res["unbroken"]["lora"],
                       None)


def test_only_rank_zero_writes(world):
    """Checkpoints (distillation and VDM) and the VDM history are written
    by rank 0 alone; the others wait at its barrier and read them."""
    stitch = [_result(world, "distillation", r) for r in range(W.WORLD)]
    vdm = [_result(world, "resume", r) for r in range(W.WORLD)]
    assert stitch[0]["saves"] == [0] and vdm[0]["saves"] == [1, 2, 1]
    assert all(s["saves"] == [] for s in stitch[1:] + vdm[1:])
    assert stitch[0]["saved"] == ["resume_checkpoint.pt",
                                  "stitched_model_epoch_0.pt"]
    assert all(v["history_file"] for v in vdm)
