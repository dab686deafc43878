"""The scene cell's run and its check, at a CPU size, and on the card.

A tiny configuration (`tiny_config.json`: UMT5 d_model 40, a 2-layer DiT
of dim 48, 3 UniPC steps, the tiny VAE and stitched decoder of the port's
tests, 56² feed-forward images, 25 orbit views) drives the cell's driver
end to end on the CPU: set-up, a window of one scene, the plain reference
and the comparison, with the look for a card skipped.  A sound run is
correct under the cell's limits; each fault the cell can have, planted in
the program underneath, and the fp8 control make it incorrect.  The mp4
writer and reader are replaced by raw frames: this machine has neither
imageio nor OpenCV.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import common, harness

CELL = "vist3a-wan2.1-1.3b.scene"
TINY = json.loads((common.HERE / "tests" / "tiny_config.json").read_text())


@pytest.fixture
def driver(monkeypatch):
    from vist3a_tpu_torch.io import video_export

    def write_raw(video, path, fps=20):
        np.save(str(path) + ".npy", video)
        return str(path)
    monkeypatch.setattr(video_export, "write_mp4", write_raw)
    drv = common.load_module(common.HERE / "drivers" / "scene.py",
                             "port_bench_driver_scene_test")
    monkeypatch.setattr(drv, "read_mp4", lambda path: np.load(path + ".npy"))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield drv
    torch.set_num_threads(n)


def _run(drv, seed=2 ** 32 + 7):
    run = harness.Run(CELL, seed, 0.0, False, common.cell(CELL), TINY,
                      time.perf_counter(), device="cpu")
    drv.setup(run)
    drv.window(run)
    drv.free(run)
    checks = drv.check(run)
    return run, checks




def test_sound_run_is_correct(driver):
    run, checks = _run(driver)
    assert run.attempted == 1
    assert harness.correct(run, checks), checks
    numbers = {n: v for n, v, _ in checks}
    assert numbers["mask_off"] == 0.0 and numbers["opacity_rel"] < 1e-6


def _state_unchanged(monkeypatch):
    from vist3a_tpu_torch.diffusion import unipc

    monkeypatch.setattr(unipc, "_step",
                        lambda per, v, x, last, m1, m2: (x, last, m1))


def _half_batch(monkeypatch):
    """The CFG pair's unconditional half left out: the guidance reads the
    conditional half alone."""
    from vist3a_tpu_torch.diffusion import unipc

    def cfg_model(dit_apply, cond, uncond, scale):
        def model_fn(x, t):
            ts = torch.as_tensor(t, dtype=torch.float32,
                                 device=x.device).expand(1)
            return dit_apply(x, ts, cond)
        return model_fn
    monkeypatch.setattr(unipc, "cfg_model", cfg_model)


def _answer_altered(monkeypatch):
    """The orbit's colours dimmed by 1 % where the renderer produces
    them."""
    from vist3a_tpu_torch.io import video_export

    real = video_export.render

    def dimmed(*a, **k):
        out = real(*a, **k)
        return out._replace(color=out.color * 0.99)
    monkeypatch.setattr(video_export, "render", dimmed)


def _file_altered(monkeypatch):
    """The PLY written with every opacity raised by 0.01."""
    from vist3a_tpu_torch.pipelines import t23d

    real = t23d.export_ply

    def altered(means, scales, rot, harmonics, opacities, path):
        return real(means, scales, rot, harmonics, opacities + 0.01, path)
    monkeypatch.setattr(t23d, "export_ply", altered)


def _mask_threshold(monkeypatch):
    """The confidence mask cut at the 20 % quantile, not the configured
    10 %."""
    from vist3a_tpu_torch.nn import encoder

    real = encoder.quantile
    monkeypatch.setattr(encoder, "quantile", lambda x, q: real(x, q + 0.1))


def _opacity_mapping(monkeypatch):
    """The opacities mapped from the squared probability."""
    from vist3a_tpu_torch.nn import encoder

    real = encoder.map_pdf_to_opacity
    monkeypatch.setattr(encoder, "map_pdf_to_opacity",
                        lambda pdf, *a, **k: real(pdf, *a, **k) ** 2)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _file_altered,
                                   _mask_threshold, _opacity_mapping],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered", "file_altered",
                              "mask_threshold", "opacity_mapping"])
def test_fault_is_not_correct(driver, monkeypatch, fault):
    fault(monkeypatch)
    run, checks = _run(driver)
    assert not harness.correct(run, checks), checks


def test_fp8_control_is_not_correct(driver):
    """The control in the program's place: the reference in bf16 over
    weights rounded to float8 e4m3."""
    run = harness.Run(CELL, 2 ** 32 + 9, 0.0, False, common.cell(CELL),
                      TINY, time.perf_counter(), device="cpu")
    numbers = driver.sweep_seed(run, False, True)["control"]
    limits = common.cell(CELL)["limits"]
    assert [n for n in limits if not numbers[n] <= limits[n]], numbers


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the cell on the card (run on the chip:
    `python3 -m pytest -m gpu port_bench/tests`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELL,
         "--seed", str(2 ** 31 + 11), "--seconds", "5", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900,
        env={**os.environ})
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
