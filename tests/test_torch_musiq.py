"""The port's MUSIQ (`vist3a_tpu_torch/eval/musiq.py`, `musiq_convert.py`)
against the JAX package's, fp32 on the CPU, at the tiny config of
`tests/test_musiq.py` (hidden 32, 2 layers, 2 heads) unless named.

  * `multiscale_tokens`: the patches within 3e-6 (the two resizes are
    `jax.image.resize`'s antialiased bilinear, rebuilt in `ops/resize.py`),
    the HSE cells and scale ids exactly, over landscape, portrait, square
    and up-scaled frames; `preprocess_frame`'s unantialiased downscale
    within 3e-6.  The limit is not 1e-6: JAX's compiled resize divides a
    column's weights by a sum that XLA recomputes in another fusion with
    other rounding (300 → 222 has a column summing to 1 + 1.4e-6), which
    the port's exactly normalised weights do not reproduce; the other
    five shapes agree within 1e-6;
  * the forward (with padded, masked slots) and the scorer within 1e-5,
    from JAX `init` params (every leaf perturbed) carried by `convert`;
  * the npz both ways: a file JAX saved loads here and scores as JAX does;
    a file saved here loads in JAX with the same values; a wrong config is
    refused;
  * `convert_state_dict` equals JAX's tree for both pyiqa spellings, and a
    missing key raises with the manifest; `synthetic_images` and
    `dump_manifest` are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_musiq import CFG as JCFG
from vist3a_tpu.eval import musiq as jm
from vist3a_tpu.eval import musiq_convert as jconv
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.eval import musiq as tm
from vist3a_tpu_torch.eval import musiq_convert as tconv

CFG = tm.MUSIQConfig(hidden=32, num_layers=2, num_heads=2, mlp_dim=64)
PATCH_ATOL = 3e-6
SCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def params():
    tree = jax.jit(jm.init, static_argnums=(1,))(jax.random.key(0), JCFG)
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def model(params):
    return convert.load_jax_musiq_params(tm.MUSIQ(CFG), params).eval()


def _frame(hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("hw", [(96, 160), (160, 96), (64, 48), (448, 448),
                                (300, 520), (500, 37)])
def test_multiscale_tokens_match_jax(hw):
    img = np.random.default_rng(2).random((*hw, 3)).astype(np.float32)
    got = tm.multiscale_tokens(img, CFG)
    want = jm.multiscale_tokens(img, JCFG)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=PATCH_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("hw", [(1024, 768), (600, 900), (300, 200)])
def test_preprocess_frame_matches_jax(hw):
    frame = _frame(hw, 3)
    got = tm.preprocess_frame(frame, tm.MUSIQConfig())
    want = jm.preprocess_frame(frame, jm.MUSIQConfig())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PATCH_ATOL)


def test_forward_matches_jax(params, model):
    rng = np.random.default_rng(4)
    n, npad = 10, 16
    pk = rng.standard_normal((2, npad, CFG.patch_dim)).astype(np.float32)
    hid = rng.integers(0, CFG.hse_grid, (2, npad, 2))
    sid = rng.integers(0, CFG.num_scales, (2, npad))
    mask = np.zeros((2, npad), bool)
    mask[0, :n] = True
    mask[1, :n + 3] = True
    pk[:, n + 3:] = 777.0                 # garbage in padded slots
    want = np.asarray(jm.forward(params, *map(jnp.asarray, (pk, hid, sid,
                                                            mask)), JCFG))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (pk, hid, sid, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL,
                               atol=SCORE_RTOL * np.abs(want).max())


def test_scorer_matches_jax(params, model):
    frames = [_frame((64, 80), 7), _frame((48, 48), 8), _frame((90, 40), 9)]
    want = jm.make_musiq_scorer(params, JCFG)(frames)
    got = tm.make_musiq_scorer(model)(frames)
    assert abs(got - want) <= SCORE_RTOL * abs(want)


def test_npz_across_packages(params, model, tmp_path):
    frames = [_frame((64, 64), 11)]
    jpath = tmp_path / "jax.npz"
    jm.save_musiq_npz(jpath, params)
    loaded = tm.load_musiq_npz(jpath, CFG, device="cpu")
    want = jm.make_musiq_scorer(params, JCFG)(frames)
    got = tm.make_musiq_scorer(loaded)(frames)
    assert abs(got - want) <= SCORE_RTOL * abs(want)
    tpath = tmp_path / "port.npz"
    tm.save_musiq_npz(tpath, tm.params_tree(model))
    back = jm.load_musiq_npz(tpath, JCFG)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        tm.load_musiq_npz(tpath, tm.MUSIQConfig(hidden=48, num_layers=2,
                                                num_heads=2, mlp_dim=64),
                          device="cpu")


def _pyiqa_state_dict(spelling: str) -> dict:
    """`tests/test_musiq.py::test_convert_state_dict_alias_spellings`'s
    state dict of each pyiqa spelling."""
    rng = np.random.default_rng(0)
    d, m = CFG.hidden, CFG.mlp_dim

    def lin(o, i):
        return rng.standard_normal((o, i)).astype(np.float32)

    def vec(n):
        return rng.standard_normal(n).astype(np.float32)

    if spelling == "encoder_layers":
        blk, root = "transformer.encoder_layers.{i}", "transformer"
        attn, ln1, ln2, mlp = (".self_attention", ".layer_norm_input",
                               ".layer_norm_out", ".mlp_block")
        names = ("embedding", "cls_token", "position_embedding",
                 "scale_embedding", "encoder_norm")
    else:
        blk, root = "transformer_encoder.encoderblock_{i}", \
            "transformer_encoder"
        attn, ln1, ln2, mlp = ".attention", ".ln1", ".ln2", ".mlp"
        names = ("embedding", "cls", "posembed_input.position_emb",
                 "scale_emb.scale_emb", "encoder_norm")
    sd = {f"{root}.{names[0]}.weight": lin(d, CFG.patch_dim),
          f"{root}.{names[0]}.bias": vec(d),
          f"{root}.{names[1]}": rng.standard_normal((1, 1, d)).astype(
              np.float32),
          f"{root}.{names[2]}": rng.standard_normal(
              (CFG.hse_grid, CFG.hse_grid, d)).astype(np.float32),
          f"{root}.{names[3]}": rng.standard_normal(
              (CFG.num_scales, d)).astype(np.float32),
          f"{root}.{names[4]}.weight": vec(d),
          f"{root}.{names[4]}.bias": vec(d)}
    for i in range(CFG.num_layers):
        p = blk.format(i=i)
        for q in ("query", "key", "value", "out"):
            sd[f"{p}{attn}.{q}.weight"] = lin(d, d)
            sd[f"{p}{attn}.{q}.bias"] = vec(d)
        for lnp in (ln1, ln2):
            sd[f"{p}{lnp}.weight"] = vec(d)
            sd[f"{p}{lnp}.bias"] = vec(d)
        sd[f"{p}{mlp}.fc1.weight"] = lin(m, d)
        sd[f"{p}{mlp}.fc1.bias"] = vec(m)
        sd[f"{p}{mlp}.fc2.weight"] = lin(d, m)
        sd[f"{p}{mlp}.fc2.bias"] = vec(d)
    sd["head.weight"] = lin(1, d)
    sd["head.bias"] = vec(1)
    return sd


@pytest.mark.parametrize("spelling", ["encoder_layers", "encoderblock"])
def test_convert_state_dict_matches_jax(spelling, tmp_path):
    sd = _pyiqa_state_dict(spelling)
    got = tconv.convert_state_dict(dict(sd), CFG)
    want = jconv.convert_state_dict(dict(sd), JCFG)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    # the converted tree loads through the validated npz and scores as JAX
    path = tmp_path / "m.npz"
    tm.save_musiq_npz(path, got)
    frames = [_frame((40, 56), 12)]
    assert abs(tm.make_musiq_scorer(tm.load_musiq_npz(path, CFG,
                                                      device="cpu"))(frames)
               - jm.make_musiq_scorer(want, JCFG)(frames)) <= \
        SCORE_RTOL * abs(jm.make_musiq_scorer(want, JCFG)(frames))
    bad = dict(sd)
    bad.pop("head.weight")
    with pytest.raises(KeyError, match="aliases"):
        tconv.convert_state_dict(bad, CFG)


def test_convert_helpers_are_jax():
    for a, b in zip(tconv.synthetic_images(), jconv.synthetic_images()):
        np.testing.assert_array_equal(a, b)
    sd = _pyiqa_state_dict("encoderblock")
    assert tconv.dump_manifest(sd) == jconv.dump_manifest(sd)
