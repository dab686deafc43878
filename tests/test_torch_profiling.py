"""The port's profiling helpers (`vist3a_tpu_torch/core/profiling.py`):
a span in `trace_to`'s profiler trace and Chrome trace, and the finite
checks.  The span recorder itself is tested in `test_torch_tracing.py`."""

import json

import numpy as np
import pytest
import torch

from vist3a_tpu_torch.core import profiling as tprof


def test_memory_report_and_range_names(tmp_path):
    """A span's profiler range appears by name in `trace_to`'s profile and
    in the Chrome trace it writes."""
    with tprof.trace_to(tmp_path / "trace") as prof:
        with tprof.span("named_range"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    names = {e.key for e in prof.key_averages()}
    assert "named_range" in names
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "named_range"
               for e in trace["traceEvents"])
    assert "named_range" in {s.name for s in tprof.spans()}


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
