"""The benchmark's import guard and its configuration files, on the CPU.

Nothing under `port_bench/` imports JAX or the JAX package (top-level
names compared whole: the port's name only begins with the JAX
package's), and the plain reference imports nothing of the port.  Each
configuration file's widths are the port's published presets.
"""

import ast
import dataclasses
from pathlib import Path

import pytest

from port_bench import common

ROOT = Path(common.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "vist3a_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "vist3a_tpu_torch" not in _imports(path)


def test_forbidden_names_are_whole():
    from port_bench import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert "vist3a_tpu_torch" not in FORBIDDEN


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _lists(x):
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    return x


@pytest.mark.parametrize("name,dit", [("vist3a-wan2.1-1.3b", "WAN_1_3B"),
                                      ("vist3a-wan2.1-14b", "WAN_14B")])
def test_config_widths_are_the_ports(name, dit):
    from vist3a_tpu_torch.nn import umt5, wan_dit
    from vist3a_tpu_torch.pipelines import t23d
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    t = common.config_file(name)["t23d"]
    want = t23d.T23DConfig()
    assert _lists(t["dit"]) == _lists(_asdict(getattr(wan_dit, dit)))
    assert _lists(t["umt5"]) == _lists(_asdict(umt5.UMT5_XXL))
    assert _lists(t["vae"]) == _lists(_asdict(want.vae))
    # the deployed decoder: StitchedConfig() with bf16 DPT-head activations
    stitched = dataclasses.replace(ca.StitchedConfig(), encoder=dataclasses.replace(
        ca.StitchedConfig().encoder, head_dtype="bfloat16"))
    assert _lists(t["stitched"]) == _lists(_asdict(stitched))
    for key in ("width", "height", "num_frames", "num_inference_steps",
                "guidance_scale", "flow_shift", "feedforward_size"):
        assert t[key] == getattr(want, key)
    cfg = common.from_dict(t23d.T23DConfig(), t)
    assert cfg == dataclasses.replace(want, dit=getattr(wan_dit, dit))


@pytest.mark.parametrize("name", ["vist3a-wan2.1-1.3b", "vist3a-wan2.1-14b"])
def test_config_file_is_whole(name):
    c = common.config_file(name)
    assert c["name"] == name
    assert c["reduced"] == []
    assert c["source"].startswith("https://")
    for o in c["weights"]["overrides"]:
        assert set(o) - {"match"} <= {"std", "mean", "scale", "value"}
