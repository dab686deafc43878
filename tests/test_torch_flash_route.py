"""Which flash-attention kernel a call takes, and the bindings around the
kernels, on the CPU (no card, no nvcc).

  * `route` sends bf16, unmasked, head_dim-128 calls (the natural entry,
    the Wan DiT's self-attention) to the wgmma + TMA kernels, fp32 to the
    FFMA kernels, and every other bf16 call to the mma.sync kernels;
  * each C entry's signature, parsed from its `.cu` source, is the
    wrapper's ctypes `argtypes`, kind by kind and in order (a pointer bound
    as an int would be cut to 32 bits without a word);
  * `build.digest` follows `#include "..."` into the `csrc/` headers, so an
    edited header never loads a stale library.
"""

import ctypes
import re
import shutil

import pytest
import torch

from vist3a_tpu_torch.kernels import build
from vist3a_tpu_torch.kernels import flash_attention as fa


@pytest.mark.parametrize("dtype,head_dim,masked,want", [
    (torch.bfloat16, 128, False, "wgmma"),
    (torch.bfloat16, 128, True, "mma_sync"),
    (torch.bfloat16, 64, False, "mma_sync"),
    (torch.bfloat16, 64, True, "mma_sync"),
    (torch.bfloat16, 96, False, "mma_sync"),
    (torch.bfloat16, 40, False, "mma_sync"),
    (torch.float32, 64, False, "fp32"),
    (torch.float32, 64, True, "fp32"),
    (torch.float32, 128, False, "fp32"),
])
def test_route_names_the_kernel(dtype, head_dim, masked, want):
    assert fa.route(dtype, head_dim, masked) == want


def _c_signature(source: str, entry: str) -> tuple:
    """The ctypes kinds of `entry`'s parameters, from its source."""
    text = (build.CSRC_DIR / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                  re.DOTALL)
    assert m, f"no extern \"C\" entry {entry} in {source}"
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("long long "):
            kinds.append(ctypes.c_longlong)
        elif param.startswith("int "):
            kinds.append(ctypes.c_int)
        elif param.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(f"{entry}: unknown parameter {param!r}")
    return tuple(kinds)


@pytest.mark.parametrize("source,entry", sorted(fa.ARGTYPES))
def test_c_entry_signature_matches_argtypes(source, entry):
    assert _c_signature(source, entry) == fa.ARGTYPES[(source, entry)]


def test_new_sources_are_the_routes_sources():
    assert fa.SM90_SOURCE == "flash_attention_fwd_sm90.cu"
    assert fa.SM90_BWD_SOURCE == "flash_attention_bwd_sm90.cu"
    for source in (fa.SM90_SOURCE, fa.SM90_BWD_SOURCE):
        assert '#include "sm90.cuh"' in (build.CSRC_DIR / source).read_text()


def test_digest_follows_included_headers(tmp_path):
    for name in ("flash_attention_fwd_sm90.cu", "flash_attention_bwd_sm90.cu",
                 "flash_attention_fwd.cu", "sm90.cuh"):
        shutil.copy(build.CSRC_DIR / name, tmp_path / name)
    fwd, bwd, old = (tmp_path / n for n in (
        "flash_attention_fwd_sm90.cu", "flash_attention_bwd_sm90.cu",
        "flash_attention_fwd.cu"))
    before = {p: build.digest(p) for p in (fwd, bwd, old)}
    assert build.digest(fwd) == before[fwd]          # deterministic
    header = tmp_path / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {p: build.digest(p) for p in (fwd, bwd, old)}
    assert after[fwd] != before[fwd] and after[bwd] != before[bwd]
    assert after[old] == before[old]       # it includes no local header
    fwd.write_text(fwd.read_text() + "\n")
    assert build.digest(fwd) != after[fwd]


def test_cpu_natural_backward_runs_plain_version_without_counting():
    """bf16 head_dim 128 on CPU tensors: the plain versions, no launch."""
    gen = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(1, 40, 2, 128, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (fa.launches_natural, fa.launches_backward_natural) == (0, 0)
