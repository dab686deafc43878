"""CogVideoX-5B on the port against its plain reference, on the CPU.

The port's T5 v1.1 variant (`nn/umt5.py`), CogVideoX DiT
(`nn/cogvideox_dit.py`), v-prediction DDIM (`diffusion/ddim.py`) and the
pipeline's `T2VConfig` path (`pipelines/t23d.py`) are held to
`reference_torch/cogvideox.py` (plain PyTorch following HF and diffusers
op for op) at a tiny width and depth, on seeded weights, in float32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from reference_torch import cogvideox as ref
from vist3a_tpu_torch.diffusion import ddim
from vist3a_tpu_torch.nn import cogvideox_dit as cvx
from vist3a_tpu_torch.nn import umt5
from vist3a_tpu_torch.pipelines import t23d

T5_TINY = dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=48,
               num_layers=3, max_sequence_length=24)
DIT_TINY = dict(num_layers=2, num_attention_heads=2, attention_head_dim=16,
                ffn_dim=64, time_embed_dim=24, text_embed_dim=32)
LATENT = (1, 16, 3, 4, 6)          # 3 frames of a 2×3 patch grid
# float32 on both sides, summed in other orders and over other op splits
RTOL = 1e-5


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _fill(seed: int, *modules) -> None:
    """The same values in every module's parameters, by registration
    order: matrices normal · fan_in^−½, biases 0.1·normal, other 1-D
    parameters 1 + 0.1·normal, T5's bias table 0.5·normal."""
    gen = torch.Generator().manual_seed(seed)
    named = [list(m.named_parameters()) for m in modules]
    assert all([(n, p.shape) for n, p in ps] == [(n, p.shape) for n, p in
                                                   named[0]] for ps in named)
    with torch.no_grad():
        for group in zip(*named):
            name, p = group[0]
            v = torch.randn(p.shape, generator=gen)
            if name.endswith("rel_bias"):
                v = 0.5 * v
            elif name.endswith("bias"):
                v = 0.1 * v
            elif p.ndim == 1:
                v = 1 + 0.1 * v
            else:
                v = v * float(np.prod(p.shape[1:])) ** -0.5
            for _, q in group:
                q.copy_(v)


def _t5_pair(seed=0):
    port = umt5.UMT5Encoder(umt5.T5Config(**T5_TINY))
    plain = ref.T5Encoder(ref.T5Config(**T5_TINY))
    _fill(seed, port, plain)
    return port, plain


def _dit_pair(seed=1, **over):
    port = cvx.CogVideoXDiT(cvx.CogVideoXConfig(**{**DIT_TINY, **over}))
    plain = ref.CogVideoXDiT(ref.CogVideoXConfig(**{**DIT_TINY, **over}))
    _fill(seed, port, plain)
    return port, plain


def _ids(n=2, length=24, seed=3):
    return torch.randint(0, T5_TINY["vocab_size"], (n, length),
                         generator=torch.Generator().manual_seed(seed))


def test_t5_shares_one_bias_table():
    """One table, layer 0's; UMT5 keeps one a layer; the preset is T5 v1.1
    XXL's widths with its vocabulary."""
    port, _ = _t5_pair()
    tables = [n for n, _ in port.named_parameters() if "rel_bias" in n]
    assert tables == ["layers.0.rel_bias"]
    own = umt5.UMT5Encoder(umt5.UMT5Config(**T5_TINY))
    assert len([n for n, _ in own.named_parameters() if "rel_bias" in n]) \
        == T5_TINY["num_layers"]
    assert dataclasses.asdict(umt5.T5_V1_1_XXL) == {
        **dataclasses.asdict(umt5.UMT5_XXL), "vocab_size": 32128}


def test_t5_unmasked_matches_reference():
    """No mask: every position attended and kept, as CogVideoX encodes."""
    port, plain = _t5_pair()
    ids = _ids()
    got = umt5.encode(port, ids, None)
    want = ref.t5_encode(plain, ids)
    assert _rel(got, want) < RTOL
    live = torch.zeros_like(ids)
    live[:, :7] = 1
    masked = umt5.encode(port, ids, live)
    assert _rel(masked[:, :7], want[:, :7]) > 1e-2      # the pads mattered


def test_umt5_encode_is_unchanged():
    """UMT5 (a table a layer, the mask) bit for bit as the benchmark's
    frozen copy of it computes."""
    from port_bench.reference import umt5 as frozen

    cfg = umt5.UMT5Config(**T5_TINY)
    port = umt5.UMT5Encoder(cfg)
    old = frozen.UMT5Encoder(frozen.UMT5Config(**T5_TINY))
    _fill(4, port, old)
    ids, live = _ids(seed=5), torch.ones(2, 24, dtype=torch.long)
    live[0, 10:] = 0
    assert torch.equal(umt5.encode(port, ids, live),
                       frozen.encode(old, ids, live))


def _block_inputs(port, seed=6):
    cfg = port.cfg
    gen = torch.Generator().manual_seed(seed)
    n_text, grid = 5, (3, 2, 3)
    e = torch.randn(2, n_text, cfg.inner_dim, generator=gen)
    x = torch.randn(2, int(np.prod(grid)), cfg.inner_dim, generator=gen)
    c = torch.randn(2, cfg.time_embed_dim, generator=gen)
    return e, x, c, grid


def test_block_matches_reference():
    """One block on the joint sequence (text first): the port's joint
    tensor, modulated and gated by slices, against the reference's two
    streams."""
    port, plain = _dit_pair()
    e, x, c, grid = _block_inputs(port)
    h = torch.cat([e, x], dim=1)
    with torch.no_grad():
        got = cvx.block_forward(port.transformer_blocks[0], h.clone(),
                                torch.nn.functional.silu(c), e.shape[1],
                                port.rope(grid, h.device), port.cfg)
        rope = ref.rotary_tables(plain.cfg, *grid, "cpu")
        want_x, want_e = ref._block(plain.transformer_blocks[0], x, e, c,
                                    rope, plain.cfg)
    assert _rel(got[:, e.shape[1]:], want_x) < RTOL
    assert _rel(got[:, :e.shape[1]], want_e) < RTOL


@pytest.mark.parametrize("fault", ["rope_on_text", "one_modulation",
                                   "no_qk_norm"])
def test_block_faults_are_seen(fault, monkeypatch):
    """Each structural fault moves the block off the reference: RoPE on the
    text tokens too, the video modulation and gate for both modalities,
    the per-head q/k norm dropped."""
    port, plain = _dit_pair()
    e, x, c, grid = _block_inputs(port)
    if fault == "rope_on_text":
        real_attn = cvx.attention
        monkeypatch.setattr(cvx, "attention",
                            lambda attn, y, n_text, rope, cfg:
                            real_attn(attn, y, 0, _padded(rope, y), cfg))
    elif fault == "one_modulation":
        real_mod, real_gate = cvx._modulate, cvx._gated_residual

        def video(m):
            return (*m[:3], *m[:3])
        monkeypatch.setattr(cvx, "_modulate", lambda h, norm, m, n:
                            real_mod(h, norm, video(m), n))
        monkeypatch.setattr(cvx, "_gated_residual", lambda h, o, m, n:
                            real_gate(h, o, video(m), n))
    else:
        monkeypatch.setattr(cvx, "layer_norm", lambda t, w, b, eps: t)
    h = torch.cat([e, x], dim=1)
    with torch.no_grad():
        got = cvx.block_forward(port.transformer_blocks[0], h.clone(),
                                torch.nn.functional.silu(c), e.shape[1],
                                port.rope(grid, h.device), port.cfg)
        rope = ref.rotary_tables(plain.cfg, *grid, "cpu")
        want_x, want_e = ref._block(plain.transformer_blocks[0], x, e, c,
                                    rope, plain.cfg)
    want = torch.cat([want_e, want_x], dim=1)
    assert _rel(got, want) > 1e-3


def _padded(rope, y):
    """The video tables with the text positions given rows 1..L of them:
    RoPE over the whole joint sequence."""
    cos, sin = rope
    n_text = y.shape[1] - cos.shape[0]
    return (torch.cat([cos[1:n_text + 1], cos]),
            torch.cat([sin[1:n_text + 1], sin]))


@pytest.mark.parametrize("seed", [1, 2])
def test_dit_matches_reference(seed):
    port, plain = _dit_pair(seed)
    gen = torch.Generator().manual_seed(seed + 10)
    latent = torch.randn(2, *LATENT[1:], generator=gen)
    text = torch.randn(2, 7, DIT_TINY["text_embed_dim"], generator=gen)
    ts = torch.tensor([999.0, 419.0])
    got = cvx.forward(port, latent, ts, text)
    want = ref.dit_forward(plain, latent, ts, text)
    assert got.shape == latent.shape
    assert _rel(got, want) < RTOL


def test_rope_tables_follow_diffusers():
    """The pair tables, repeated pairwise, are diffusers' 3D tables: head
    dim 64 split (16, 24, 24), the published grid."""
    cfg = cvx.COGVIDEOX_5B
    cos, sin = cvx.rope_tables(cfg, 13, 30, 45)
    rcos, rsin = ref.rotary_tables(ref.CogVideoXConfig(), 13, 30, 45, "cpu")
    assert cos.shape == (13 * 30 * 45, 32)
    assert torch.allclose(cos.repeat_interleave(2, 1), rcos, atol=2e-5)
    assert torch.allclose(sin.repeat_interleave(2, 1), rsin, atol=2e-5)


def test_ddim_schedule():
    """ᾱ₉₉₉ = 0 (zero terminal SNR), timesteps 999, 979, …, 19, ᾱ_prev = 1
    after the last step (its update returns x₀), the reference's
    coefficients."""
    cfg = ddim.DDIMConfig()
    ab = ddim.alphas_cumprod(cfg)
    assert ab[-1] == 0.0 and abs(ab[0] - (1 - 0.00085)) < 1e-12
    ts = ddim.timesteps(cfg)
    assert ts.tolist() == list(range(999, 0, -20))
    c = ddim.precompute_coeffs(cfg)
    assert c["prev_x"][-1] == 0.0 and c["prev_x0"][-1] == 1.0
    assert c["x0_x"][0] == 0.0 and c["x0_v"][0] == 1.0
    for i, (t, a_t, a_prev) in enumerate(ref.schedule(ref.SchedulerConfig(),
                                                      50)):
        assert t == ts[i]
        assert np.isclose(c["x0_x"][i], np.sqrt(a_t), rtol=1e-6, atol=1e-7)
        assert np.isclose(c["prev_x"][i], np.sqrt((1 - a_prev) / (1 - a_t)),
                          rtol=1e-6)


def test_ddim_chain_matches_reference():
    """Three steps of the chain over a fixed model, v-prediction."""
    gen = torch.Generator().manual_seed(8)
    z = torch.randn(LATENT, generator=gen)
    w = torch.randn(LATENT, generator=gen)

    def model_fn(x, t):
        return 0.5 * x + w * (float(t) / 1000.0)
    cfg = ddim.DDIMConfig(num_steps=3)
    got = ddim.sample_scan(model_fn, z, cfg)
    want = ref.sample(model_fn, z, ref.SchedulerConfig(), 3)
    assert ddim.timesteps(cfg).tolist() == [999, 666, 332]
    assert _rel(got, want) < 1e-6


def _tokenize(text):
    r = np.random.default_rng(len(text))
    ids = r.integers(0, T5_TINY["vocab_size"], (1, 24))
    mask = np.zeros((1, 24), np.int64)
    mask[0, :min(len(text.split()), 24)] = 1
    return ids, mask


def test_pipeline_denoise_matches_reference():
    """`embed_prompts` and `denoise` with a `T2VConfig`: T5 without a mask,
    the negative prompt "", CFG over the pair [uncond, cond], three DDIM
    steps, against the reference's chain."""
    t5, t5_ref = _t5_pair(11)
    dit, dit_ref = _dit_pair(12)
    cfg = t23d.T2VConfig(width=48, height=32, num_frames=9,
                         num_inference_steps=3, guidance_scale=6.0,
                         dit=dit.cfg, t5=t5.cfg)
    assert cfg.latent_shape == (1, 16, 3, 4, 6)
    cond, uncond = t23d.embed_prompts(t5, _tokenize, "a red fox",
                                      device="cpu", cfg=cfg)
    want_c, want_u = ref.embed(t5_ref, _tokenize, "a red fox", "cpu")
    assert _rel(cond, want_c) < RTOL and _rel(uncond, want_u) < RTOL
    z = torch.randn(cfg.latent_shape,
                    generator=torch.Generator().manual_seed(13))
    got = t23d.denoise(dit, cond, uncond, cfg, latents0=z, device="cpu")
    model_fn = ref.cfg_model(
        lambda x, ts, text: ref.dit_forward(dit_ref, x, ts, text),
        want_c, want_u, 6.0)
    want = ref.sample(model_fn, z, ref.SchedulerConfig(), 3)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-4
