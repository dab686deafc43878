"""The benchmark's FLOP counts and copied arithmetic, on the CPU.

The counts read the configuration files; here they are held to
`torch.utils.flop_counter` over the port's own modules built on the meta
device at the published widths (no memory, no compute), and the copies to
the numbers of their originals.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import common, flopcount
from port_bench import trace as trace_mod

CONFIGS = ("vist3a-wan2.1-1.3b", "vist3a-wan2.1-14b")


def _t23d(name):
    return flopcount.ns(common.config_file(name)["t23d"])


def _port_cfg(name):
    from vist3a_tpu_torch.pipelines import t23d

    return common.from_dict(t23d.T23DConfig(),
                            common.config_file(name)["t23d"])


def _counted(fn) -> int:
    with torch.device("meta"), FlopCounterMode(display=False) as fcm:
        fn()
    return fcm.get_total_flops()


@pytest.mark.parametrize("name", CONFIGS)
def test_cfg_step_matches_flop_counter(name):
    from vist3a_tpu_torch.nn import wan_dit

    cfg = _port_cfg(name)
    lat = flopcount.latent_grid(_t23d(name))

    def step():
        dit = wan_dit.WanDiT(cfg.dit).to(torch.bfloat16)
        x = torch.empty(2, 16, *lat, dtype=torch.bfloat16)
        text = torch.empty(2, cfg.umt5.max_sequence_length, cfg.dit.text_dim,
                           dtype=torch.bfloat16)
        wan_dit.forward(dit, x, torch.empty(2), text)
    assert flopcount.cfg_step_flops(_t23d(name)) == _counted(step)


def test_dit_counts_as_issued():
    """2.715×10¹³ (1.3B) and 2.268×10¹⁴ (14B) FLOP a CFG step at 4096
    tokens and 226 text tokens."""
    assert flopcount.dit_tokens(_t23d(CONFIGS[0])) == 4096
    assert flopcount.cfg_step_flops(_t23d(CONFIGS[0])) == 27_152_072_835_072
    assert flopcount.cfg_step_flops(_t23d(CONFIGS[1])) == \
        pytest.approx(2.268e14, rel=1e-3)


def test_umt5_matches_flop_counter():
    from vist3a_tpu_torch.nn import umt5

    cfg = _port_cfg(CONFIGS[0])
    n = cfg.umt5.max_sequence_length

    def encode():
        model = umt5.UMT5Encoder(cfg.umt5).to(torch.bfloat16)
        ids = torch.zeros(1, n, dtype=torch.long)
        umt5.encode(model, ids, torch.ones(1, n, dtype=torch.long))
    assert flopcount.umt5_flops(_t23d(CONFIGS[0]), prompts=1) == \
        _counted(encode)


def test_vae_decode_matches_flop_counter():
    from vist3a_tpu_torch.nn import wan_vae

    cfg = _port_cfg(CONFIGS[0])
    lat = flopcount.latent_grid(_t23d(CONFIGS[0]))

    def decode():
        vae = wan_vae.WanVAEDecoder(cfg.vae).to(torch.bfloat16)
        z = torch.empty(1, 16, *lat, dtype=torch.bfloat16)
        vae.decoder(vae.post_quant_conv(z))
    assert flopcount.vae_decode_flops(_t23d(CONFIGS[0])) == _counted(decode)


@pytest.mark.parametrize("name", CONFIGS)
def test_stitched_count_is_bench_pys(name):
    """`bench.py::_flops` gives 45,352,302,641,152 FLOP for one forward of
    `StitchedConfig()` at 13 frames of 448²."""
    t = _t23d(name)
    assert flopcount.stitched_flops(t.stitched, 448, 13) == 45_352_302_641_152


def test_attention_bound_is_perf_mds():
    """PERF.md's row 3 bound: 0.2085 ms at (2, 4096, 12, 128), 0.6948 ms at
    the 14B's 40 heads; row 1's 0.05701 ms at (13, 1029, 16, 64)."""
    assert flopcount.attention_bound_s(2, 4096, 12, 128) * 1e3 == \
        pytest.approx(0.2085, abs=1e-4)
    assert flopcount.attention_bound_s(2, 4096, 40, 128) * 1e3 == \
        pytest.approx(0.6948, abs=1e-4)
    assert flopcount.attention_bound_s(13, 1029, 16, 64) * 1e3 == \
        pytest.approx(0.05701, abs=1e-5)


def test_scene_launches_are_the_programs_counts():
    """A scene launches 1500 natural, 8 unmasked and 48 masked flash calls
    (the counts PERF.md gives for a `text_to_3dgs` request)."""
    got = flopcount.scene_attention_launches(_t23d(CONFIGS[0]))
    counts = {k: sum(c for c, *_ in v) for k, v in got.items()}
    assert counts == {"flash_natural": 1500, "flash_unmasked": 8,
                      "flash_masked": 48}


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::flash_fwd_sm90_kernel<128, false>(CUtensorMap_st)",
    "void (anonymous namespace)::flash_fwd_sm90_kernel<64, true>(CUtensorMap_st)",
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast>",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>",
    "composite_fwd_kernel",
    "Memcpy HtoD (Pageable -> Device)",
    "void cudnn::ops::nchwToNhwcKernel",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel",
    "some_unknown_kernel"])
def test_kernel_group_is_chip_smokes(kernel):
    import chip_smoke

    assert trace_mod.kernel_group(kernel) == chip_smoke._kernel_group(kernel)
