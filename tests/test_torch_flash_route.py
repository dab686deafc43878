"""Which flash-attention kernel a call takes, and the bindings around the
kernels, on the CPU (no card, no nvcc).

  * `route` sends bf16 calls at head_dim 64 and 128, masked or not (the
    stitched decoder's and the Wan DiT's attention), to the wgmma + TMA
    kernels, fp32 to the 3×TF32 wgmma + TMA kernels, and the other bf16
    head dims to the mma.sync kernels;
  * `key_bias`, the key validity as the wgmma forward reads it, gives the
    plain version's masked result when added to the scores;
  * each C entry's signature, parsed from its `.cu` source, is the
    wrapper's ctypes `argtypes`, kind by kind and in order (a pointer bound
    as an int would be cut to 32 bits without a word);
  * `build.digest` follows `#include "..."` into the `csrc/` headers, so an
    edited header never loads a stale library;
  * every planted fault of `tools/torch_flash_mutants.py` still finds the
    text it replaces, once, in its source.
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
    (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 64, False, "wgmma"),
    (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 96, False, "mma_sync"),
    (torch.bfloat16, 96, True, "mma_sync"),
    (torch.bfloat16, 40, False, "mma_sync"),
    (torch.bfloat16, 40, True, "mma_sync"),
    (torch.bfloat16, 48, False, "mma_sync"),
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
    assert fa.F32_SOURCE == "flash_attention_fwd_f32_sm90.cu"
    assert fa.F32_BWD_SOURCE == "flash_attention_bwd_f32_sm90.cu"
    for source in (fa.SM90_SOURCE, fa.SM90_BWD_SOURCE, fa.F32_SOURCE,
                   fa.F32_BWD_SOURCE):
        assert '#include "sm90.cuh"' in (build.CSRC_DIR / source).read_text()


def test_ffma_fp32_kernels_are_gone():
    """The fp32 calls have one route: no FFMA kernel or C entry is left
    to fall back to."""
    for source in (fa.SOURCE, fa.BWD_SOURCE):
        text = (build.CSRC_DIR / source).read_text()
        for name in ("flash_fwd_f32_kernel", "launch_f32",
                     "flash_bwd_dkv_kernel(", "flash_bwd_dq_kernel(",
                     "flash_attention_bwd_f32("):
            assert name not in text, (source, name)
    assert not any(entry.endswith("_f32") for _, entry in fa.ARGTYPES)


def _mutants():
    import importlib.util

    path = build.PACKAGE_DIR.parent / "tools" / "torch_flash_mutants.py"
    spec = importlib.util.spec_from_file_location("torch_flash_mutants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MUTANTS = _mutants()


@pytest.mark.parametrize("name", sorted(_MUTANTS.MUTANTS))
def test_mutant_edit_applies_once(name):
    """Each edit finds its text once (`_mutate` raises otherwise), in the
    source or in a header it includes, and the mutant changes a file."""
    m = _MUTANTS.MUTANTS[name]
    texts = _MUTANTS.mutated_texts(build.CSRC_DIR, name)
    assert set(texts) == {m["source"], *m["headers"]}
    assert any(text != (build.CSRC_DIR / file).read_text()
               for file, text in texts.items())
    for header in m["headers"]:
        assert f'#include "{header}"' in \
            (build.CSRC_DIR / m["source"]).read_text()


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


@pytest.mark.parametrize("n_k,dead", [
    (1040, "frame"),          # 11 dead keys end the frame, inside a tile
    (13520, "frames"),        # 13 such frames: dead keys in many tiles
    (130, "all"),             # no live key: O = 0, LSE the sentinel
    (77, "none"),             # below one tile: only the padding is −∞
    (256, "alternate")])      # whole tiles, every other key dead
def test_key_bias_is_the_plain_mask(n_k, dead):
    """The padded fp32 row the wgmma forward adds to its scores: 0 for a
    live key, −∞ for a dead one and for every key up to the next whole
    tile; and each tile's flag, set where the tile holds a −∞ (the kernel
    adds the bias of those tiles only).  Added to the scores it gives
    every dead and padded key a P of exactly 0, and the plain version's masked O and LSE up to the order of
    the sums (the padded keys add exact zeros, which change only torch's
    reduction tree: O within one bf16 step of itself or 1e-6 near 0, LSE
    within 1e-6 of itself)."""
    idx = torch.arange(n_k)
    live = {"frame": idx < n_k - 11,
            "frames": idx % 1040 < 1029,
            "all": torch.zeros(n_k, dtype=torch.bool),
            "none": torch.ones(n_k, dtype=torch.bool),
            "alternate": idx % 2 == 0}[dead]
    bias, tile_masked = fa.key_bias(live)
    assert bias.dtype == torch.float32 and tile_masked.dtype == torch.uint8
    assert bias.shape == (-(-n_k // fa.KEY_TILE) * fa.KEY_TILE,)
    assert torch.equal(bias[:n_k] == 0, live)
    assert bool(torch.isneginf(bias[:n_k][~live]).all())
    assert bool(torch.isneginf(bias[n_k:]).all())
    # a tile's flag: whether any of its keys is dead or beyond N_k
    dead_or_pad = torch.cat([~live, torch.ones(bias.shape[0] - n_k,
                                               dtype=torch.bool)])
    assert torch.equal(tile_masked.bool(),
                       dead_or_pad.view(-1, fa.KEY_TILE).any(1))
    # the kernel adds the bias only where the flag is set
    bias = torch.where(tile_masked.bool().repeat_interleave(fa.KEY_TILE),
                       bias, torch.zeros_like(bias))

    gen = torch.Generator().manual_seed(n_k)
    n_q = 50
    q = torch.randn(1, n_q, 2, 64, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(1, n_k, 2, 64, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, live)
    # the kernel's arithmetic on the biased scores, padded keys included
    pad = bias.shape[0] - n_k
    kp, vp = (torch.cat([x, torch.zeros(1, pad, 2, 64, dtype=x.dtype)], 1)
              for x in (k, v))
    s2 = torch.einsum("bnhd,bmhd->bhnm", q.float(), kp.float()) \
        * (64 ** -0.5 * fa._LOG2E) + bias
    m = s2.amax(dim=-1, keepdim=True).clamp_min(fa._NEG_BIG)
    p = torch.exp2(s2 - m)
    assert not bool(p[..., :n_k][..., ~live].any())
    assert not bool(p[..., n_k:].any())
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = (torch.einsum("bhnm,bmhd->bnhd", p, vp.float())
         / safe_l.squeeze(-1).transpose(1, 2)[..., None]).to(torch.bfloat16)
    lse = (m + torch.log2(safe_l)).squeeze(-1) / fa._LOG2E
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2 ** -8,
                               atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-6, atol=0)
    if dead == "all":
        assert not bool(o.any())
        assert bool((lse == fa._NEG_BIG / fa._LOG2E).all())
