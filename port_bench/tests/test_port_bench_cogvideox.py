"""The CogVideoX cell's configuration, counts, run and check, on the CPU.

The configuration file holds the port's published presets; the FLOP
count of a CFG step is held to `torch.utils.flop_counter` on the port's
DiT built on the meta device at the published widths.  The tiny
configuration of `tiny_cogvideox.json` (T5 d_model 32, a 2-layer DiT of
width 32, 3 DDIM steps) drives the cell's driver: a window of a few
seconds, the plain reference on the program's own state, and the
comparison.  A sound run is correct under the cell's limits; each fault
the cell can have, planted in the program underneath, and the fp8
control make it incorrect.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import common, flopcount_cogvideox as fc, harness

CELL = "cogvideox-5b.joint-denoise"
CONFIG = "cogvideox-5b"
TINY = json.loads((common.HERE / "tests" / "tiny_cogvideox.json").read_text())


def test_config_widths_are_the_ports():
    from vist3a_tpu_torch.diffusion import ddim
    from vist3a_tpu_torch.nn import cogvideox_dit, umt5
    from vist3a_tpu_torch.pipelines import t23d

    c = common.config_file(CONFIG)
    assert c["name"] == CONFIG and c["reduced"] == []
    t = c["t2v"]
    assert t["dit"] == dataclasses.asdict(cogvideox_dit.COGVIDEOX_5B)
    assert t["t5"] == dataclasses.asdict(umt5.T5_V1_1_XXL)
    assert common.from_dict(t23d.T2VConfig(), t) == t23d.T2VConfig()
    sched = {k: v for k, v in dataclasses.asdict(ddim.DDIMConfig()).items()
             if k != "num_steps"}
    assert c["scheduler"] == sched
    for o in c["weights"]["overrides"]:
        assert set(o) - {"match"} <= {"std", "mean", "scale", "value"}


def test_reference_takes_the_same_parameters():
    """The reference's modules hold the program's parameters in the
    program's order (one weight stream fills both alike)."""
    from port_bench.reference import cogvideox as ref
    from vist3a_tpu_torch.nn import cogvideox_dit, umt5
    from vist3a_tpu_torch.pipelines import t23d

    cfg = common.from_dict(t23d.T2VConfig(), TINY["t2v"])
    pairs = ((umt5.UMT5Encoder(cfg.t5), ref.T5Encoder(
                 ref.T5Config(**TINY["t2v"]["t5"]))),
             (cogvideox_dit.CogVideoXDiT(cfg.dit), ref.CogVideoXDiT(
                 ref.CogVideoXConfig(**TINY["t2v"]["dit"]))))
    for port, plain in pairs:
        assert [(n, p.shape) for n, p in port.named_parameters()] == \
            [(n, p.shape) for n, p in plain.named_parameters()]


def test_reference_is_the_repos():
    """The benchmark's frozen copy is the repository's plain reference as
    this cell was written."""
    assert (common.HERE / "reference" / "cogvideox.py").read_text() == \
        (common.ROOT / "reference_torch" / "cogvideox.py").read_text()


def test_cfg_step_matches_flop_counter():
    """6.64×10¹⁴ FLOP a CFG step at 17,550 video and 226 text tokens: the
    DiT's matrix products and attention cores, as FlopCounterMode counts
    them on the port's DiT."""
    from vist3a_tpu_torch.nn import cogvideox_dit

    t2v = fc.ns(common.config_file(CONFIG)["t2v"])
    assert fc.video_tokens(t2v) == 17550 and fc.joint_tokens(t2v) == 17776
    s, layers, per_block = 17776, 42, 4 * 3072 ** 2 + 2 * 3072 * 12288
    dominant = 2 * (2 * s * layers * per_block + 4 * s * s * 64 * 48 * layers)
    flops = fc.cfg_step_flops(t2v)
    assert flops == pytest.approx(6.64e14, rel=1e-2)
    assert flops == pytest.approx(dominant, rel=1e-3)

    def step():
        dit = cogvideox_dit.CogVideoXDiT().to(torch.bfloat16)
        cogvideox_dit.forward(dit, torch.empty(2, 16, 13, 60, 90),
                              torch.empty(2),
                              torch.empty(2, 226, 4096, dtype=torch.bfloat16))
    with torch.device("meta"), FlopCounterMode(display=False) as fcm:
        step()
    assert flops == fcm.get_total_flops()


@pytest.fixture
def driver():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield common.load_module(common.HERE / "drivers" / "joint_denoise.py",
                             "port_bench_driver_joint_denoise_test")
    torch.set_num_threads(n)


def _run(drv, seed=2 ** 32 + 31, seconds=2.0):
    run = harness.Run(CELL, seed, seconds, False, common.cell(CELL),
                      TINY, time.perf_counter(), device="cpu")
    drv.setup(run)
    drv.window(run)
    drv.free(run)
    return run, drv.check(run)


def test_sound_run_is_correct(driver):
    run, checks = _run(driver)
    assert run.attempted >= 2 and run.failed == 0
    assert run.counters["steps"] > TINY["t2v"]["num_inference_steps"]
    assert run.e2e["denoise_step_ms"] > 0
    assert harness.correct(run, checks), checks
    numbers = dict((n, v) for n, v, _ in checks)
    assert numbers["chain_rel"] == 0.0 and numbers["inputs_rel"] == 0.0


def test_window_shorter_than_the_checked_steps_fails(driver):
    """A window that ends before the first request completed the steps the
    check needs is a failed run."""
    run, checks = _run(driver, seconds=0.0)
    assert run.counters["steps"] == 1 and run.failed == 1
    assert not harness.correct(run, checks)


def test_cut_request_is_checked(driver):
    """A request cut after some of its steps, as the window cuts the first
    at the published size: the latents the cut step's pre-hook saw are the
    reference chain's after the completed steps."""
    cfg = json.loads(json.dumps(TINY))
    cfg["t2v"]["num_inference_steps"] = 5
    run = harness.Run(CELL, 2 ** 32 + 33, 0.0, False, common.cell(CELL),
                      cfg, time.perf_counter(), device="cpu")
    run.state["cfg"] = driver.program_config(run)
    run.state["tokenize"] = common.tokenizer(16, 64)
    got = driver.program_request(run, 3)
    assert len(got["steps"]) == 3
    numbers = driver.reference_numbers(run, got)
    limits = common.cell(CELL)["limits"]
    assert all(numbers[n] <= limits[n] for n in limits), numbers
    assert numbers["chain_rel"] == 0.0


def _rope_on_text(monkeypatch):
    """RoPE over the whole joint sequence: the text positions rotated too
    (by the first rows of the video's tables)."""
    from vist3a_tpu_torch.nn import cogvideox_dit as cvx

    real = cvx.attention

    def attention(attn, y, n_text, rope, cfg):
        cos, sin = rope
        rope = (torch.cat([cos[1:n_text + 1], cos]),
                torch.cat([sin[1:n_text + 1], sin]))
        return real(attn, y, 0, rope, cfg)
    monkeypatch.setattr(cvx, "attention", attention)


def _one_modulation(monkeypatch):
    """The video's shift, scale and gate for the text tokens as well."""
    from vist3a_tpu_torch.nn import cogvideox_dit as cvx

    real_mod, real_gate = cvx._modulate, cvx._gated_residual

    def video(m):
        return (*m[:3], *m[:3])
    monkeypatch.setattr(cvx, "_modulate",
                        lambda h, norm, m, n: real_mod(h, norm, video(m), n))
    monkeypatch.setattr(cvx, "_gated_residual",
                        lambda h, o, m, n: real_gate(h, o, video(m), n))


def _no_qk_norm(monkeypatch):
    """The per-head q/k LayerNorm dropped."""
    from vist3a_tpu_torch.nn import cogvideox_dit as cvx

    monkeypatch.setattr(cvx, "layer_norm", lambda t, w, b, eps: t)


def _eps_prediction(monkeypatch):
    """The DiT's output read as ε, not v: x₀ = (x − √(1 − ᾱ)·ε)/√ᾱ."""
    from vist3a_tpu_torch.diffusion import ddim

    def step(per, eps, x):
        x0 = (x - per["x0_v"] * eps) / per["x0_x"]
        return per["prev_x"] * x + per["prev_x0"] * x0
    monkeypatch.setattr(ddim, "_step", step)


def _t5_pads_masked(monkeypatch):
    """T5 given a mask (the stand-in's pads, past the prompt's words)
    where CogVideoX gives none."""
    from vist3a_tpu_torch.nn import umt5
    from vist3a_tpu_torch.pipelines import t23d

    def embed_prompts(enc, tokenize, prompt, *, device, cfg):
        out = []
        for text in (t23d.ORBIT_PROMPT_TEMPLATE.format(prompt=prompt),
                     t23d.T2V_NEGATIVE_PROMPT):
            ids, mask = (torch.as_tensor(np.asarray(a), device=device)
                         for a in tokenize(text))
            out.append(umt5.encode(enc, ids, mask))
        return out[0], out[1]
    monkeypatch.setattr(t23d, "embed_prompts", embed_prompts)


@pytest.mark.parametrize("fault", [_rope_on_text, _one_modulation,
                                   _no_qk_norm, _eps_prediction,
                                   _t5_pads_masked],
                         ids=["rope_on_text", "one_modulation", "no_qk_norm",
                              "eps_prediction", "t5_pads_masked"])
def test_fault_is_not_correct(driver, monkeypatch, fault):
    fault(monkeypatch)
    run, checks = _run(driver)
    assert not harness.correct(run, checks), checks


def test_fp8_control_is_not_correct(driver):
    run = harness.Run(CELL, 2 ** 32 + 23, 0.0, False, common.cell(CELL),
                      TINY, time.perf_counter(), device="cpu")
    numbers = driver.sweep_seed(run, False, True)["control"]
    limits = common.cell(CELL)["limits"]
    assert [n for n in limits if not numbers[n] <= limits[n]], numbers
