"""The port's Qwen2.5-VL (`vist3a_tpu_torch/nn/qwen_vl.py`) against the JAX
package's `vist3a_tpu/nn/qwen_vl.py`, fp32 on the CPU, at the tiny
configs of `tests/test_qwen_vl.py` (4 vision blocks, two of them full
attention; 3 GQA decoder layers, 4 query and 2 kv heads).  The JAX params
come from `vision_init` / `text_init` with every leaf perturbed (so a
swapped norm or bias shows) and are carried over by `convert`.

  * the vision tower, on a grid whose windows tile it, on the ragged-window
    grid of `test_vision_tower_ragged_windows` and on two frames: within
    1e-5 of the output's largest magnitude;
  * the host helpers (`get_rope_index` with images, video and none,
    `patchify`, `smart_resize`, `window_partition`) exactly;
  * the VQA logits (vision scatter + mrope decoder) and the text-only
    prompt's: within 1e-4 of their largest magnitude;
  * greedy generation: the same tokens, with and without an end token;
  * bf16, as the judge is deployed: each decoder function and a whole
    layer against JAX's run op by op (at most 1 % of the elements
    differ; the reading was none), and the whole tiny judge against JAX's
    compiled decoder (logits within 0.02 of their largest, the same
    greedy tokens);
  * `import_hf_qwen_vl` of a state dict fabricated from the port's modules
    (`io/manifests.py::_fab_qwen_vl`) under both key prefixes: equal to the
    JAX import carried over, exactly; a stray key raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_qwen_vl import SPECIAL, TCFG, VCFG
from vist3a_tpu.nn import qwen_vl as jq
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.io import manifests as tmf
from vist3a_tpu_torch.nn import qwen_vl as tq

VISION_RTOL = 1e-5
LOGITS_RTOL = 1e-4


def port_config(cls, cfg):
    """The port's config class holding a JAX config's values."""
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


TV = port_config(tq.QwenVLVisionConfig, VCFG)
TT = port_config(tq.QwenVLTextConfig, TCFG)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: under the suite's parallel workers, torch's
    intra-op threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), tree)


def jax_judge_params(vcfg=VCFG, tcfg=TCFG):
    """(vision, text) JAX trees from `vision_init` / `text_init` (jitted),
    every leaf perturbed."""
    vis = jax.jit(jq.vision_init, static_argnums=(1,))(jax.random.key(0),
                                                       vcfg)
    txt = jax.jit(jq.text_init, static_argnums=(1,))(jax.random.key(1), tcfg)
    return _perturbed(vis, 2), _perturbed(txt, 3)


def port_judge(params, tv=TV, tt=TT):
    """The port's modules holding the JAX trees' values."""
    vis = convert.load_jax_qwen_vision_params(tq.QwenVLVision(tv), params[0])
    txt = convert.load_jax_qwen_text_params(tq.QwenVLText(tt), params[1])
    return vis.eval(), txt.eval()


@pytest.fixture(scope="module")
def params():
    return jax_judge_params()


@pytest.fixture(scope="module")
def modules(params):
    return port_judge(params)


def _patches(seed, grid):
    gt, gh, gw = grid
    return np.random.default_rng(seed).standard_normal(
        (gt * gh * gw, TV.patch_dim)).astype(np.float32)


def _prompt_ids(grid):
    gt, gh, gw = grid
    n_img = gt * gh * gw // VCFG.spatial_merge_size ** 2
    return np.asarray([5, 6, 7, SPECIAL["vision_start_token_id"]]
                      + [SPECIAL["image_token_id"]] * n_img
                      + [SPECIAL["vision_end_token_id"], 9, 10, 11, 12],
                      np.int64)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("grid", [(1, 8, 8), (1, 12, 8), (2, 8, 12)])
def test_vision_tower_matches_jax(params, modules, grid):
    """(1, 8, 8): windows tile the grid; (1, 12, 8): the ragged windows of
    `test_vision_tower_ragged_windows`; (2, 8, 12): two temporal groups."""
    flat = _patches(0, grid)
    want = np.asarray(jq.vision_features(params[0], jnp.asarray(flat), grid,
                                         VCFG))
    with torch.no_grad():
        got = tq.vision_features(modules[0], torch.from_numpy(flat), grid)
    assert got.shape == want.shape
    assert _rel(got, want) <= VISION_RTOL


@pytest.mark.parametrize("case", ["image", "two_images", "video", "text"])
def test_get_rope_index_is_jax(case):
    img = (1, 8, 8)
    vid = (2, 4, 8)
    s, pad, e = (SPECIAL["vision_start_token_id"], SPECIAL["image_token_id"],
                 SPECIAL["vision_end_token_id"])
    if case == "image":
        ids, grids, vgrids, spg = _prompt_ids(img), [img], None, None
    elif case == "two_images":
        ids = np.asarray([3, s, *[pad] * 16, e, 4, 5, s, *[pad] * 8, e, 6])
        grids, vgrids, spg = [img, (1, 4, 8)], None, None
    elif case == "video":
        ids = np.asarray([3, 4, s, *[SPECIAL["video_token_id"]] * 16, e, 7])
        grids, vgrids, spg = [], [vid], [0.5]
    else:
        ids, grids, vgrids, spg = np.arange(3, 12), [], None, None
    want = jq.get_rope_index(ids, grids, TCFG, VCFG, second_per_grid_ts=spg,
                             video_grid_thw=vgrids)
    got = tq.get_rope_index(ids, grids, TT, TV, second_per_grid_ts=spg,
                            video_grid_thw=vgrids)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("hw", [(28, 56), (56, 84), (112, 28)])
def test_host_helpers_are_jax(hw):
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((3, 3, *hw)).astype(np.float32)
    big = jq.QWEN25_VL_7B_VISION
    got, grid = tq.patchify(frames, tq.QWEN25_VL_7B_VISION)
    want, jgrid = jq.patchify(frames, big)
    assert grid == jgrid
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tq.window_partition(grid, tq.QWEN25_VL_7B_VISION),
                    jq.window_partition(jgrid, big)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tq.vision_rope_freqs(grid, tq.QWEN25_VL_7B_VISION),
        jq.vision_rope_freqs(jgrid, big))
    for h, w, lo, hi in ((hw[0] * 7, hw[1] * 5, 56 * 56, 14 * 14 * 4 * 1280),
                         (hw[0], hw[1], 16, 64), (37, 5000, 3136, 1 << 20)):
        assert tq.smart_resize(h, w, 28, lo, hi) == \
            jq.smart_resize(h, w, 28, lo, hi)


def test_vqa_logits_match_jax(params, modules):
    """input ids + pixels → logits through the vision scatter and the mrope
    decoder, and the last row alone (`last_only`)."""
    grid = (1, 8, 8)
    flat = _patches(2, grid)
    ids = _prompt_ids(grid)
    vis, txt = params
    img = jq.vision_features(vis, jnp.asarray(flat), grid, VCFG)
    pos, _ = jq.get_rope_index(ids, [grid], TCFG, VCFG)
    emb = jq.embed_tokens(txt, jnp.asarray(ids.astype(np.int32)), img, TCFG)
    want = np.asarray(jq.text_forward(txt, emb, jnp.asarray(pos), TCFG)[0])
    with torch.no_grad():
        timg = tq.vision_features(modules[0], torch.from_numpy(flat), grid)
        temb = tq.embed_tokens(modules[1], torch.from_numpy(ids), timg)
        got = tq.text_forward(modules[1], temb, torch.from_numpy(pos))[0]
        last = tq.text_forward(modules[1], temb, torch.from_numpy(pos),
                               last_only=True)[0]
    assert _rel(got, want) <= LOGITS_RTOL
    assert _rel(last[0], want[-1]) <= LOGITS_RTOL


def test_text_only_prompt(params, modules):
    """No image: the positions are 1-D; the logits still match."""
    ids = np.asarray([3, 4, 5, 6, 7, 8], np.int64)
    pos, _ = jq.get_rope_index(ids, [], TCFG, VCFG)
    emb = jq.embed_tokens(params[1], jnp.asarray(ids.astype(np.int32)),
                          None, TCFG)
    want = np.asarray(jq.text_forward(params[1], emb, jnp.asarray(pos),
                                      TCFG)[0])
    with torch.no_grad():
        got = tq.text_forward(
            modules[1], tq.embed_tokens(modules[1], torch.from_numpy(ids),
                                        None), torch.from_numpy(pos))[0]
    assert _rel(got, want) <= LOGITS_RTOL


@pytest.mark.parametrize("stop", [False, True])
def test_greedy_tokens_match_jax(params, modules, stop):
    """The same 8 tokens; with `stop`, the third token is made an end token
    and both stop before it."""
    grid = (1, 4, 4)
    flat = _patches(3, grid)
    ids = _prompt_ids(grid)
    vis, txt = params
    img = jq.vision_features(vis, jnp.asarray(flat), grid, VCFG)
    pos, delta = jq.get_rope_index(ids, [grid], TCFG, VCFG)
    want = jq.greedy_generate(txt, ids.astype(np.int32), img, pos, delta,
                              TCFG, max_new_tokens=8)
    tmod = modules[1]
    if stop:
        tcfg = dataclasses.replace(TCFG, eos_token_ids=(want[2],))
        want = jq.greedy_generate(txt, ids.astype(np.int32), img, pos,
                                  delta, tcfg, max_new_tokens=8)
        tmod = port_judge(params, TV, port_config(tq.QwenVLTextConfig,
                                                  tcfg))[1]
        assert len(want) == 2
    with torch.no_grad():
        timg = tq.vision_features(modules[0], torch.from_numpy(flat), grid)
    got = tq.greedy_generate(tmod, ids, timg, pos, delta, max_new_tokens=8)
    assert got == want


@pytest.mark.parametrize("legacy", [False, True])
def test_import_hf_matches_jax(modules, legacy):
    sd = tmf._fab_qwen_vl(*modules, legacy=legacy)
    jvis, jtxt = jq.import_hf_qwen_vl({k: v.numpy() for k, v in sd.items()},
                                      VCFG, TCFG)
    want_v = convert.load_jax_qwen_vision_params(
        tq.QwenVLVision(TV), jax.tree.map(np.asarray, jvis)).state_dict()
    want_t = convert.load_jax_qwen_text_params(
        tq.QwenVLText(TT), jax.tree.map(np.asarray, jtxt)).state_dict()
    got_v, got_t = tq.import_hf_qwen_vl(sd, TV, TT)
    for got, want in ((got_v, want_v), (got_t, want_t)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k].reshape(want[k].shape), want[k]), k
    with pytest.raises(ValueError, match="not consumed"):
        tq.import_hf_qwen_vl({**sd, "lm_head.bias":
                              torch.zeros(1)}, TV, TT)


# bf16, the judge as deployed: the JAX trees cast to bf16 and the port's
# modules cast the same way hold identical weights.  Run op by op, JAX
# rounds every step to bf16, as the port does; the reading was 0 differing
# elements for each function below, the limit allows 1 % for a change of
# the matmuls' summation order.
BF16_DIFFER_FRAC = 0.01
# the whole judge against JAX's compiled decoder (its layers under
# `lax.scan`, its generation under `jax.jit`, where XLA keeps some bf16
# intermediates in fp32): 0.0082 of the largest logit at the reading
BF16_LOGITS_RTOL = 0.02


@pytest.fixture(scope="module")
def bf16_judge(params, modules):
    """(JAX trees, port modules), both holding the bf16-rounded weights."""
    trees = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    mods = tuple(port_judge(params)[i].to(torch.bfloat16) for i in (0, 1))
    return trees, mods


def _bf16_host(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _bf16_array(rng, shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)


@pytest.mark.parametrize("fn", ["rms_norm", "linear", "swiglu", "attention",
                                "mrope", "text_layer"])
def test_bf16_numerics_match_jax(bf16_judge, fn):
    """Each function of the decoder in bf16 against JAX's run op by op:
    `_rms_norm` rounding before the weight, `_Linear` rounding the product
    before the bias, SiLU's logistic rounded at each step, GQA attention
    with the probabilities rounded, the mrope tables, and a whole layer
    (rope, cache, causal mask)."""
    (_, jt), (_, tt) = bf16_judge
    p0 = jax.tree.map(lambda a: a[0], jt["layers"])
    l0 = tt.layers[0]
    rng = np.random.default_rng(11)
    h, kvh, dh = TCFG.num_heads, TCFG.num_kv_heads, TCFG.head_dim
    grid = (1, 8, 8)
    ids = _prompt_ids(grid)
    n = len(ids)
    x = _bf16_array(rng, (n, TCFG.hidden_size))
    xt = _bf16_host(x).to(torch.bfloat16)
    pos, _ = jq.get_rope_index(ids, [grid], TCFG, VCFG)
    causal = jnp.where(jnp.arange(n)[None] <= jnp.arange(n)[:, None], 0.0,
                       -jnp.inf)[None].astype(jnp.float32)
    with torch.no_grad():
        if fn == "rms_norm":
            want = jq._rms_norm(p0["ln1"], x, TCFG.rms_eps)
            got = tq._rms_norm(l0.ln1, xt, TT.rms_eps)
        elif fn == "linear":
            want = jq._lin(p0["q"], x)
            got = l0.q(xt)
        elif fn == "swiglu":
            want = jq._swiglu(p0["mlp"], x)
            got = l0.mlp(xt)
        elif fn == "attention":
            q, k, v = (_bf16_array(rng, (n, m, dh)) for m in (h, kvh, kvh))
            want = jq._masked_attention(q, jnp.repeat(k, h // kvh, 1),
                                        jnp.repeat(v, h // kvh, 1), causal,
                                        dh ** -0.5)
            got = tq._masked_attention(
                *(_bf16_host(t).to(torch.bfloat16) for t in (q, k, v)),
                _bf16_host(causal), dh ** -0.5)
        elif fn == "mrope":
            want = jnp.stack(jq._mrope_tables(jnp.asarray(pos), TCFG,
                                              jnp.bfloat16))
            got = torch.stack(tq._mrope_tables(torch.from_numpy(pos), TT,
                                               torch.bfloat16))
        else:
            cos, sin = jq._mrope_tables(jnp.asarray(pos), TCFG, jnp.bfloat16)
            cache = jnp.zeros((n, kvh, dh), jnp.bfloat16)
            want = jq._text_layer(p0, x, cos, sin, cache, cache, 0, causal,
                                  TCFG)[0]
            tcache = torch.zeros((2, n, kvh, dh), dtype=torch.bfloat16)
            got = tq._text_layer(
                l0, xt, *tq._mrope_tables(torch.from_numpy(pos), TT,
                                          torch.bfloat16),
                tcache[0], tcache[1], 0, _bf16_host(causal), TT)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = _bf16_host(want)
    assert got.shape == want.shape
    assert float((got.float() != want).float().mean()) <= BF16_DIFFER_FRAC


def test_bf16_judge_matches_jax(bf16_judge):
    """The tiny judge with bf16 weights, as `qwen_judge._run` drives it:
    the vision tower (fp32 activations over bf16 weights, in both) within
    `VISION_RTOL`, the prefill logits within `BF16_LOGITS_RTOL` of their
    largest, and the same 16 greedy tokens."""
    (jv, jt), (tv, tt) = bf16_judge
    for grid, seed in (((1, 8, 8), 2), ((1, 4, 4), 3)):
        flat = _patches(seed, grid)
        ids = _prompt_ids(grid)
        img = jq.vision_features(jv, jnp.asarray(flat), grid, VCFG)
        pos, delta = jq.get_rope_index(ids, [grid], TCFG, VCFG)
        emb = jq.embed_tokens(jt, jnp.asarray(ids.astype(np.int32)), img,
                              TCFG)
        want = np.asarray(jq.text_forward(jt, emb, jnp.asarray(pos),
                                          TCFG)[0])
        with torch.no_grad():
            timg = tq.vision_features(tv, torch.from_numpy(flat), grid)
            temb = tq.embed_tokens(tt, torch.from_numpy(ids), timg)
            got = tq.text_forward(tt, temb, torch.from_numpy(pos))[0]
        assert temb.dtype == torch.bfloat16
        assert _rel(timg, np.asarray(img)) <= VISION_RTOL
        assert _rel(got, want) <= BF16_LOGITS_RTOL
        assert tq.greedy_generate(tt, ids, timg, pos, delta,
                                  max_new_tokens=16) == jq.greedy_generate(
            jt, ids.astype(np.int32), img, pos, delta, TCFG,
            max_new_tokens=16)
