"""The port's profiling helpers (`vist3a_tpu_torch/core/profiling.py`)
against the JAX package's `Benchmarker` contract (`tests/test_gen_eval.py::
test_benchmarker`): named wall-clock ranges with their JSON dump and means,
the per-device memory report, a profiler trace, and the finite checks.
On the CPU no range synchronises and the memory report is empty (the JAX
package's CPU devices report none either)."""

import json

import numpy as np
import pytest
import torch

from vist3a_tpu.core import profiling as jprof
from vist3a_tpu_torch.core import profiling as tprof


def test_benchmarker_times_dumps_and_summarizes(tmp_path):
    b = tprof.Benchmarker(device="cpu")
    with b.time("phase_a"):
        torch.ones(64, 64).sum()
    with b.time("phase_b", num_calls=4):
        torch.ones(8).sum()
    with pytest.raises(RuntimeError):
        with b.time("phase_a"):
            raise RuntimeError("inside")
    times = b.execution_times
    assert len(times["phase_a"]) == 2 and len(times["phase_b"]) == 4
    assert times["phase_b"][0] == times["phase_b"][3] >= 0.0
    summary = b.summarize()
    assert summary["phase_a"] == pytest.approx(sum(times["phase_a"]) / 2)
    b.dump(tmp_path / "deep" / "times.json")
    assert json.loads((tmp_path / "deep" / "times.json").read_text()) == \
        {k: list(v) for k, v in times.items()}
    jb = jprof.Benchmarker()
    with jb.time("phase_b", num_calls=4):
        pass
    assert set(jb.summarize()) <= set(summary)


def test_memory_report_and_range_names(tmp_path):
    b = tprof.Benchmarker(device="cpu")
    b.dump_memory(tmp_path / "mem.json")
    memory = json.loads((tmp_path / "mem.json").read_text())
    assert memory == {} if not torch.cuda.is_available() else \
        set(memory["cuda:0"]) == {"bytes_in_use", "peak_bytes_in_use"}
    with tprof.trace_to(tmp_path / "trace") as prof:
        with b.time("named_range"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    names = {e.key for e in prof.key_averages()}
    assert "named_range" in names
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "named_range"
               for e in trace["traceEvents"])


@pytest.mark.parametrize("tree,bad", [
    ({"x": torch.ones(3)}, None),
    ({"a": {"b": [torch.ones(2), torch.tensor([1.0, np.inf])]},
      "c": torch.zeros(2)}, "a/b/1"),
    ({"w": torch.tensor([np.nan]), "n": torch.tensor([1, 2]),
      "s": "text"}, "w"),
    ({"half": torch.tensor([np.nan], dtype=torch.bfloat16)}, "half")])
def test_assert_all_finite(tree, bad):
    if bad is None:
        tprof.assert_all_finite(tree, "ok")
        return
    with pytest.raises(FloatingPointError, match=f"in bad: \\['{bad}'\\]"):
        tprof.assert_all_finite(tree, "bad")


def test_debug_nan_mode():
    assert not torch.is_anomaly_enabled()
    try:
        tprof.debug_nan_mode(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        tprof.debug_nan_mode(False)
    assert not torch.is_anomaly_enabled()
