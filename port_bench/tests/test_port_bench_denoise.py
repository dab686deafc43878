"""The denoise cell's run and its check at a CPU size.

The tiny configuration of `tiny_config.json` (UMT5 d_model 40, a 2-layer
DiT of dim 48, 3 UniPC steps) drives the cell's driver on the CPU: a
window of a few seconds, the plain reference on the program's own state,
and the comparison, with the look for a card skipped.  A sound run is
correct under the cell's limits; each fault the cell can have, planted in
the program underneath, and the fp8 control make it incorrect.
"""

import json
import time

import pytest
import torch

from port_bench import common, harness

CELL = "vist3a-wan2.1-14b.denoise"
TINY = json.loads((common.HERE / "tests" / "tiny_config.json").read_text())


@pytest.fixture
def driver():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield common.load_module(common.HERE / "drivers" / "denoise.py",
                             "port_bench_driver_denoise_test")
    torch.set_num_threads(n)


def _run(drv, seed=2 ** 32 + 21, seconds=2.0):
    run = harness.Run(CELL, seed, seconds, False, common.cell(CELL),
                      TINY, time.perf_counter(), device="cpu")
    drv.setup(run)
    drv.window(run)
    drv.free(run)
    return run, drv.check(run)




def test_sound_run_is_correct(driver):
    run, checks = _run(driver)
    assert run.attempted >= 2 and run.failed == 0
    steps = run.counters["steps"]
    assert steps > TINY["t23d"]["num_inference_steps"]
    assert run.e2e["denoise_step_ms"] > 0
    assert harness.correct(run, checks), checks


def test_window_ends_after_the_step_in_flight(driver):
    """A window shorter than one request: the request stops at a step
    boundary, nothing was finished to compare, the run is not correct."""
    run, checks = _run(driver, seconds=0.0)
    assert run.counters["steps"] == 1 and run.failed == 1
    assert not harness.correct(run, checks)


def _state_unchanged(monkeypatch):
    from vist3a_tpu_torch.diffusion import unipc

    monkeypatch.setattr(unipc, "_step",
                        lambda per, v, x, last, m1, m2: (x, last, m1))


def _half_batch(monkeypatch):
    """The CFG pair's unconditional half left out."""
    from vist3a_tpu_torch.diffusion import unipc

    def cfg_model(dit_apply, cond, uncond, scale):
        def model_fn(x, t):
            ts = torch.as_tensor(t, dtype=torch.float32,
                                 device=x.device).expand(1)
            return dit_apply(x, ts, cond)
        return model_fn
    monkeypatch.setattr(unipc, "cfg_model", cfg_model)


def _cond_for_uncond(monkeypatch):
    """The CFG pair's text is [cond, cond]: the unconditional prompt lost,
    the batch still two."""
    from vist3a_tpu_torch.diffusion import unipc

    real = unipc.cfg_model
    monkeypatch.setattr(unipc, "cfg_model",
                        lambda dit_apply, cond, uncond, scale:
                        real(dit_apply, cond, cond, scale))


def _stale_latents(monkeypatch):
    """The DiT is given the request's noise at every step, not the
    sampler's latents."""
    from vist3a_tpu_torch.diffusion import unipc

    real = unipc.cfg_model

    def cfg_model(dit_apply, cond, uncond, scale):
        first = []
        inner = real(dit_apply, cond, uncond, scale)

        def model_fn(x, t):
            first.append(first[0] if first else x.clone())
            return inner(first[0], t)
        return model_fn
    monkeypatch.setattr(unipc, "cfg_model", cfg_model)


def _answer_altered(monkeypatch):
    """The request's latents moved by 1 % where the sampler returns them."""
    from vist3a_tpu_torch.diffusion import unipc

    real = unipc.sample_scan
    monkeypatch.setattr(unipc, "sample_scan",
                        lambda *a, **k: real(*a, **k) * 1.01)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _cond_for_uncond, _stale_latents,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch",
                              "cond_for_uncond", "stale_latents",
                              "answer_altered"])
def test_fault_is_not_correct(driver, monkeypatch, fault):
    fault(monkeypatch)
    run, checks = _run(driver)
    assert not harness.correct(run, checks), checks


def test_sound_run_records_every_step_on_the_host(driver):
    """Every step of the compared request is recorded, on the host, and
    the program's DiT inputs equal the reference chain's."""
    run = harness.Run(CELL, 2 ** 32 + 25, 2.0, False, common.cell(CELL),
                      TINY, time.perf_counter(), device="cpu")
    driver.setup(run)
    driver.window(run)
    steps = run.state["steps"]
    assert len(steps) == TINY["t23d"]["num_inference_steps"]
    assert all(t.device.type == "cpu" for s in steps for t in s)
    driver.free(run)
    checks = dict((n, v) for n, v, _ in driver.check(run))
    assert checks["inputs_rel"] == 0.0, checks


def test_fp8_control_is_not_correct(driver):
    run = harness.Run(CELL, 2 ** 32 + 23, 0.0, False, common.cell(CELL),
                      TINY, time.perf_counter(), device="cpu")
    numbers = driver.sweep_seed(run, False, True)["control"]
    limits = common.cell(CELL)["limits"]
    assert [n for n in limits if not numbers[n] <= limits[n]], numbers
