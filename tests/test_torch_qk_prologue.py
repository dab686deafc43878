"""The Wan DiT's q/k prologue (`kernels/qk_prologue.py`) on the CPU.

The wrapper's plain version, which CPU tensors take, must be the DiT's
composition before the kernel bit for bit: the QKV bias added to the whole
product, the q/k `rms_norm` across the full width, `apply_rope` on the
(B, N, H, Dh) view.  `attention()` must give the outputs it gave before,
and its grad and tensor-parallel paths must keep the torch ops and never
call the wrapper.  The kernel itself is held against the plain version on
the card (`tests/test_torch_gpu.py`, `chip_smoke.py` phase `kernels`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vist3a_tpu_torch.kernels import qk_prologue as qkp
from vist3a_tpu_torch.nn import wan_dit
from vist3a_tpu_torch.nn.layers import rms_norm

HEAD_DIM = 128
EPS = 1e-6
GRID = (1, 2, 3)          # 6 tokens
TEXT_LEN = 5


def _t(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)


def _composition(x, biases, scales, rope, heads):
    """The DiT's chain before the kernel: one bias add over the product,
    the split, `rms_norm` on the normed parts and RoPE on their heads."""
    b, n, _ = x.shape
    y = x + torch.cat(biases).to(x.dtype)
    parts = y.split(biases[0].shape[0], dim=-1)
    outs = []
    for i, part in enumerate(parts):
        if i < len(scales):
            part = rms_norm(scales[i], part, EPS)
        part = part.reshape(b, n, heads, HEAD_DIM)
        if i < len(scales) and rope is not None:
            part = wan_dit.apply_rope(part, *rope)
        outs.append(part)
    return outs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [12, 40])
@pytest.mark.parametrize("case", ["self_rope", "self", "cross"])
def test_plain_version_is_the_dits_composition(dtype, heads, case):
    """The wrapper on CPU tensors against the DiT's composition, bit for
    bit: the self-attention's three parts with and without the RoPE
    tables, and the cross-attention's one."""
    rng = np.random.default_rng(heads)
    d = heads * HEAD_DIM
    n_parts, n_norm = (1, 1) if case == "cross" else (3, 2)
    n = int(np.prod(GRID))
    x = _t(rng, (2, n, n_parts * d), dtype, 3.0)
    biases = tuple(_t(rng, (d,), dtype) for _ in range(n_parts))
    scales = tuple(_t(rng, (d,), dtype) for _ in range(n_norm))
    cfg = wan_dit.WanDiTConfig(dim=d, num_heads=heads)
    rope = wan_dit.rope_tables(cfg, *GRID) if case == "self_rope" else None
    got = qkp.qk_prologue(x, biases, scales, EPS, HEAD_DIM, rope)
    want = _composition(x, biases, scales, rope, heads)
    assert len(got) == n_parts
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.is_contiguous()
        assert torch.equal(g, w)


def _tiny(dtype):
    cfg = wan_dit.WanDiTConfig(dim=2 * HEAD_DIM, ffn_dim=64, num_layers=1,
                               num_heads=2, text_dim=32, freq_dim=32)
    gen = torch.Generator().manual_seed(0)
    dit = wan_dit.init(cfg, gen, device="cpu", dtype=dtype)
    p = wan_dit._sub(dict(dit.named_parameters()), "blocks.0.attn1.")
    rng = np.random.default_rng(1)
    # non-trivial biases and norm scales (init draws ones for the scales)
    p = {k: _t(rng, v.shape, dtype, 0.5) if k.endswith("bias")
         or k.startswith("norm") else v.detach() for k, v in p.items()}
    x = _t(rng, (2, int(np.prod(GRID)), cfg.dim), dtype)
    text = _t(rng, (2, TEXT_LEN, cfg.dim), dtype)
    rope = wan_dit.rope_tables(cfg, *GRID)
    return cfg, p, x, text, rope


def _old_attention(p, x, context, rope, cfg):
    """`attention()` without TP as it was before the kernel."""
    b, n, _ = x.shape
    dh, d = cfg.head_dim, p["q.weight"].shape[0]
    h = d // dh
    if context is None:
        w = torch.cat([p["q.weight"], p["k.weight"], p["v.weight"]])
        bias = torch.cat([p["q.bias"], p["k.bias"], p["v.bias"]])
        qkv = F.linear(x, w.to(x.dtype)) + bias.to(x.dtype)
        q, k, v = qkv.split(d, dim=-1)
        context_len, impl = n, "auto"
    else:
        q, k, v = (wan_dit._linear(p, "q", x),
                   wan_dit._linear(p, "k", context),
                   wan_dit._linear(p, "v", context))
        context_len, impl = context.shape[1], "plain"
    q = rms_norm(p["norm_q"], q, cfg.eps).reshape(b, n, h, dh)
    k = rms_norm(p["norm_k"], k, cfg.eps).reshape(b, context_len, h, dh)
    v = v.reshape(b, context_len, h, dh)
    if rope is not None:
        q = wan_dit.apply_rope(q, *rope)
        k = wan_dit.apply_rope(k, *rope)
    out = wan_dit.dot_product_attention(q, k, v, impl=impl)
    return wan_dit._linear(p, "o", out.reshape(b, n, d))


class _Counting:
    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return qkp.qk_prologue(*args, **kwargs)


def _identity(x, group):
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_attention_routes_by_tp_and_grad_and_keeps_its_outputs(
        monkeypatch, dtype, kind):
    """Inference without TP calls the wrapper (once for the self-attention,
    once each for the cross-attention's q and k) and gives the old outputs
    bit for bit; with grad enabled, or under TP (a one-rank stand-in whose
    collectives are the identity), the wrapper is never called and the
    output is the old one too, and with grad so is every gradient."""
    cfg, p, x, text, rope = _tiny(dtype)
    context, rope = (None, rope) if kind == "self" else (text, None)
    counting = _Counting()
    monkeypatch.setattr(wan_dit, "qk_prologue", counting)
    with torch.inference_mode():
        want = _old_attention(p, x, context, rope, cfg)
        got = wan_dit.attention(p, x, context, rope, cfg)
    assert counting.calls == (1 if kind == "self" else 2)
    assert torch.equal(got, want)

    counting.calls = 0
    with torch.enable_grad():
        grad_p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        got = wan_dit.attention(grad_p, x, context, rope, cfg)
        got.float().sum().backward()
        old_p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        _old_attention(old_p, x, context, rope, cfg).float().sum().backward()
    assert counting.calls == 0
    assert torch.equal(got.detach(), want)
    for k, v in old_p.items():
        assert torch.equal(grad_p[k].grad, v.grad), k

    for name in ("copy_to_model", "reduce_from_model", "sum_over_model"):
        monkeypatch.setattr(wan_dit, name, _identity)
    tp = wan_dit.TensorParallel(group=None, size=1, rank=0)
    with torch.inference_mode():
        got = wan_dit.attention(p, x, context, rope, cfg, tp)
    assert counting.calls == 0
    assert torch.equal(got, want)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    """The wrapper's checks, which a CUDA call meets before any launch; a
    meta tensor (the FLOP counts' trace) takes the plain version."""
    x = torch.empty(1, 4, 3 * 256, device="meta", dtype=torch.bfloat16)
    b = tuple(torch.empty(256, device="meta") for _ in range(3))
    outs = qkp.qk_prologue(x, b, b[:2], EPS, HEAD_DIM)
    assert [o.shape for o in outs] == [(1, 4, 2, HEAD_DIM)] * 3
    good = torch.zeros(1, 4, 3 * 256, dtype=torch.bfloat16)
    biases = tuple(torch.zeros(256, dtype=torch.bfloat16) for _ in range(3))
    for args, match in (
            ((good.float(), biases, biases[:2], HEAD_DIM, None), "bf16"),
            ((good, biases, tuple(t.float() for t in biases[:2]), HEAD_DIM,
              None), "bf16"),
            ((good[..., :512].contiguous(), biases, biases[:2], HEAD_DIM,
              None), "parts of"),
            ((good, biases, biases, HEAD_DIM, None), "1-2 of them normed"),
            ((good, biases, biases[:2], 12, None), "whole heads"),
            ((good, biases, biases[:2], HEAD_DIM,
              (torch.zeros(3, 64), torch.zeros(3, 64))), "RoPE tables")):
        with pytest.raises((TypeError, ValueError), match=match):
            qkp._check(*args)
