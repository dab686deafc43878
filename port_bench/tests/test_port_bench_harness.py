"""The harness's arithmetic and its data-driven lookup, on synthetic
timings on the CPU (no card: the look for one is stubbed)."""

import json
import shutil
import sys

import pytest
import torch

from port_bench import common, harness
from port_bench import trace as trace_mod

CELL = "vist3a-wan2.1-1.3b.scene"


def test_cell_and_metric_files_found_by_name():
    bench = harness.benchmark()
    cell = common.cell(CELL)
    assert cell["name"] == CELL and cell["limits"]
    assert common.config_file(cell["config"])["name"] == cell["config"]
    assert cell["traffic_params"]["name"] == cell["traffic"]
    assert callable(harness.load_driver(cell).window)
    e2e = [m["name"] for m in harness.cell_metrics(bench, CELL, False)]
    assert set(e2e) == {"scene_s", "setup_s"}
    for m in harness.cell_metrics(bench, CELL, True):
        reader = common.load_module(
            common.HERE / "layer_metrics" / f"{m['name']}.py", m["name"])
        assert callable(reader.read)


def test_every_benchmark_entry_has_its_files():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = common.cell(w["name"])
        assert common.load_json(common.HERE / "cells" / f"{w['name']}.json")[
            "name"] == w["name"]
        assert (common.HERE / cell["traffic_params"]["prompts"]).is_file()
    for c in bench["configs"]:
        assert (common.ROOT / c["file"]).is_file()
    for m in bench["per_layer"]:
        assert (common.HERE / "layer_metrics" / f"{m['name']}.py").is_file()


def test_idle_share_and_gaps_from_kernel_intervals():
    tr = trace_mod.Trace(
        ops=[("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)],
        ranges=[("bench.export", 2.0, 5.0), ("export.mp4_write", 4.0, 5.0)],
        window=(0.0, 5.0))
    assert tr.busy_s() == pytest.approx(3.0)
    assert tr.window_s == pytest.approx(5.0)
    assert tr.idle_gaps() == [("bench.export", pytest.approx(1.0)),
                              ("export.mp4_write", pytest.approx(1.0))]
    from port_bench.layer_metrics_common import idle_share

    class R:
        trace_data = tr
    assert idle_share(R) == pytest.approx(40.0)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["b", pytest.approx(1.5)]
    assert len(b["idle_gaps"]) == 2


def test_scene_window_counts_the_scene_in_flight(monkeypatch):
    """Scenes of 7 s on a 20 s window: three start before 20 s, the third
    ends at 21 s and counts: 21 s over 3 scenes."""
    drv = common.load_module(common.HERE / "drivers" / "scene.py", "drv")
    clock = [100.0]
    monkeypatch.setattr(drv.time, "perf_counter", lambda: clock[0])

    def fake_scene(run, mods, cfg, i, folder):
        clock[0] += 7.0
        return {"index": i, "folder": folder}
    monkeypatch.setattr(drv, "one_scene", fake_scene)
    run = harness.Run(CELL, 5, 20.0, False, {}, {}, 0.0, device="cpu")
    run.state.update(cfg=None, mods=None, tmp="/nonexistent")
    drv.window(run)
    assert run.attempted == 3
    assert run.e2e["scene_s"] == pytest.approx(7.0)


def _fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "fake")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *_: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *_: 123)


SYNTHETIC_DRIVER = '''
from port_bench import trace as trace_mod

def setup(run):
    pass

def window(run):
    run.attempted = 4
    run.e2e["toy_s"] = 2.5
    run.spans = [("bench.toy", 0.0, 2.5, 1)]
    run.trace_data = trace_mod.Trace(ops=[("k", 0.0, 1.0)],
                                     ranges=[("bench.toy", 0.0, 2.0)],
                                     window=(0.0, 2.0))

def free(run):
    pass

def check(run):
    return [("toy_rel", 0.01, run.cell["limits"]["toy_rel"])]
'''

SYNTHETIC_METRIC = '''
def read(run):
    return run.spans[0][2] - run.spans[0][1]
'''


@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_and_metric_are_files_plus_entries(tmp_path, monkeypatch,
                                                    capsys, trace):
    """A configuration, a traffic mix with its driver, a cell and a
    per-layer metric added as new files plus new entries in
    BENCHMARK.json, with no file of the benchmark edited; the result's
    last line."""
    root = tmp_path / "checkout"
    shutil.copytree(common.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    pb = root / "port_bench"
    shutil.copy(pb / "configs" / "vist3a-wan2.1-1.3b.json",
                pb / "configs" / "toy.json")
    (pb / "drivers" / "synthetic.py").write_text(SYNTHETIC_DRIVER)
    (pb / "layer_metrics" / "toy_span_s.py").write_text(SYNTHETIC_METRIC)
    (pb / "traffic" / "toy.json").write_text(json.dumps(
        {"name": "toy", "driver": "synthetic"}))
    (pb / "cells" / "toy.cell.json").write_text(json.dumps(
        {"name": "toy.cell", "limits": {"toy_rel": 0.1}}))
    bench["workloads"].append({"name": "toy.cell", "config": "toy",
                               "traffic": "toy", "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "toy_s", "unit": "s",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.cell"]})
    bench["per_layer"].append({"name": "toy_span_s", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "toy", "moves": "toy_s",
                               "workloads": ["toy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(common, "HERE", pb)
    monkeypatch.setattr(common, "ROOT", root)
    _fake_card(monkeypatch)
    assert harness.main(["--workload", "toy.cell", "--seed", str(2 ** 33),
                         "--seconds", "1", "--trace", str(trace)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys
    assert list(out)[-1] == "checks"
    assert set(out) - set(keys) - {"checks"} == ({"breakdown"} if trace
                                                else set())
    assert out["correct"] is True and out["attempted"] == 4
    assert out["checks"] == {"toy_rel": {"value": 0.01, "limit": 0.1}}
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["metrics"] == {"toy_span_s": {"value": 2.5, "unit": "s"}}
        assert out["device"]["busy_s"] == pytest.approx(1.0)
        assert out["device"]["window_s"] == pytest.approx(2.0)
    else:
        assert set(out["metrics"]) == {"toy_s", "setup_s"}
        assert out["metrics"]["toy_s"]["value"] == 2.5


def test_no_card_no_result(capsys):
    """Without a card the run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        harness.main(["--workload", CELL, "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "vist3a_tpu_torch_x", object())
    assert "vist3a_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.forbidden_modules()


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.\-]{1,16}"


def test_benchmark_json_keeps_its_limits():
    """The shape `BENCHMARK.json` has to keep: its keys, names, units, one
    line of at most 200 characters for every why, layer and source."""
    import re

    raw = (common.ROOT / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])

    def line(text):
        return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text

    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.fullmatch(NAME, c["name"]) and line(c["source"])
        assert line(c["why"]) and c["file"].startswith("port_bench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.fullmatch(NAME, w["name"]) and re.fullmatch(NAME,
                                                              w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.fullmatch(NAME, m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert re.fullmatch(UNIT, m["unit"]) and m["better"] in ("lower",
                                                                  "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
