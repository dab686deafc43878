"""The port's importers and manifests against the JAX package's.

  * Deployed widths, free (meta device): for each family the port's
    `expected_keys` equals the JAX package's committed
    `manifests/<family>.txt`; the port's copy of every manifest equals the
    JAX file byte for byte; the port's importer applied to
    `fabricate_from(load_manifest(family))` yields exactly the keys and
    shapes of the port's module; validation fails loudly.
  * Tiny configs: the JAX fabricator `manifests._fab_*` over a tiny JAX
    `init` tree gives the reference keys and shapes; a state dict of those,
    random from a numpy seed (the size-only keys in the reference's own
    broadcast shapes), goes through the JAX importer followed by
    `convert` and through the port's importer.  Both must agree tensor by
    tensor, exactly in fp32 (an import is a rename and a reshape), and
    every key must be consumed (the port raises otherwise).
  * `apply_peft_lora` and the stitched checkpoint (`import_stitched_
    checkpoint` + `lora_from_flat` + `merge_lora`, vit_chop > 0,
    bias="lora_only"): the merge w + s·(B@A) is a matmul that numpy, XLA
    and torch sum in their own orders, so merged weights agree within
    1e-6 of the weight's largest magnitude (a few fp32 ulps; a wrong
    factor, scale or layout moves them by O(1)); every other tensor
    exactly.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_slice import _configs
from vist3a_tpu.core.partition import graft as jgraft
from vist3a_tpu.io import manifests as jmf
from vist3a_tpu.io import weight_import as jwi
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import umt5 as jumt5
from vist3a_tpu.nn import wan_dit as jdit
from vist3a_tpu.nn import wan_vae as jvae
from vist3a_tpu.stitch import lora as jlora
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.io import manifests as tmf
from vist3a_tpu_torch.io import weight_import as twi
from vist3a_tpu_torch.nn import umt5 as tumt5
from vist3a_tpu_torch.nn import wan_dit as tdit
from vist3a_tpu_torch.nn import wan_vae as tvae
from vist3a_tpu_torch.nn.encoder import Encoder
from vist3a_tpu_torch.nn.layers import build_random
from vist3a_tpu_torch.stitch import lora as tlora

FAMILIES = ("anysplat_encoder", "wan_vae", "wan_dit_1_3b", "wan_dit_14b",
            "umt5_xxl")
MERGE_RTOL = 1e-6

VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
           temperal_downsample=(False, True, True))
DIT = dict(dim=48, ffn_dim=96, num_layers=2, num_heads=4, freq_dim=32,
           text_dim=24)
UMT5 = dict(vocab_size=96, d_model=32, d_kv=8, num_heads=4, d_ff=48,
            num_layers=3)


# --------------------------------------------------------------------------- #
# deployed widths                                                             #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", FAMILIES)
def test_expected_keys_equal_the_jax_manifest(family):
    assert tmf.expected_keys(family) == jmf.load_manifest(family)


@pytest.mark.parametrize("name", sorted(
    p.name for p in jmf.MANIFEST_DIR.glob("*.txt")))
def test_manifest_copies_are_the_jax_files(name):
    assert (tmf.MANIFEST_DIR / name).read_bytes() == \
        (jmf.MANIFEST_DIR / name).read_bytes()


def _deployed_import(family, sd):
    if family == "anysplat_encoder":
        return {"": (twi.import_anysplat_encoder(sd),
                     twi.encoder_skeleton())}
    if family == "wan_vae":
        halves = twi.import_wan_vae(sd)
        return {k: (halves[k], m) for k, m in twi.vae_skeletons().items()}
    if family == "umt5_xxl":
        return {"": (twi.import_umt5(sd), twi.on_meta(
            lambda: tumt5.UMT5Encoder(tumt5.UMT5_XXL)))}
    cfg = tdit.WAN_14B if family.endswith("14b") else tdit.WAN_1_3B
    return {"": (twi.import_wan_dit(sd),
                 twi.on_meta(lambda: tdit.WanDiT(cfg)))}


@pytest.mark.parametrize("family", FAMILIES)
def test_import_of_the_fabricated_manifest_fills_the_module(family):
    sd = tmf.fabricate_from(tmf.load_manifest(family))
    assert tmf.validate_state_dict(sd, family)
    for state, module in _deployed_import(family, sd).values():
        own = module.state_dict()
        assert set(state) == set(own)
        for k, v in own.items():
            assert tuple(state[k].shape) == tuple(v.shape), k


def test_validate_fails_loudly_and_honours_ignores():
    sd = tmf.fabricate_from(tmf.load_manifest("umt5_xxl"))
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]   # ignored
    assert tmf.validate_state_dict(sd, "umt5_xxl")
    bad = dict(sd)
    bad.pop("encoder.final_layer_norm.weight")
    bad["encoder.block.0.layer.0.SelfAttention.q.weight"] = \
        torch.zeros(3, 3)
    bad["encoder.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError) as err:
        tmf.validate_state_dict(bad, "umt5_xxl")
    text = str(err.value)
    assert "1 missing" in text and "1 unconsumed" in text \
        and "1 shape mismatches" in text
    dit = tmf.fabricate_from(tmf.load_manifest("wan_dit_14b"))
    assert tmf.validate_wan_dit(dit) is dit
    # the importer is strict on its own as well
    with pytest.raises(KeyError, match="not consumed"):
        twi.import_umt5(bad)
    # the scorer families have their fabricators since the text towers
    assert tmf.expected_keys("pickscore") == tmf.load_manifest("pickscore")


# --------------------------------------------------------------------------- #
# tiny configs: the port's importer against JAX importer + convert            #
# --------------------------------------------------------------------------- #
def _ref_shape(key, spec, family):
    if not (spec and spec[0] == "size"):
        return tuple(spec)
    n = spec[1]
    if family == "wan_vae":          # diffusers' broadcast RMS gammas
        return (n, 1, 1) if ".attentions." in key else (n, 1, 1, 1)
    rows = 6 if key.startswith("blocks.") else 2        # (1, rows, D)
    return (1, rows, n // rows)


def _random_sd(exp, family, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(_ref_shape(k, spec, family))
            .astype(np.float32) for k, spec in sorted(exp.items())}


def _jax_fab(fab, tree):
    out = {}
    fab(tree, out)
    return out


def _assert_equal(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert port[k].dtype == torch.float32
        np.testing.assert_array_equal(port[k].numpy(), v.numpy(), err_msg=k)


def _torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_anysplat_encoder_import_matches_jax():
    jcfg, tcfg = _configs()
    tree = jax.eval_shape(lambda k: jenc.init(k, jcfg.encoder),
                          jax.random.key(0))
    sd = _random_sd(_jax_fab(jmf._fab_anysplat_encoder, tree),
                    "anysplat_encoder", 0)
    sd["encoder.track_head.x.weight"] = np.zeros(3, np.float32)  # ignored
    want = convert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jwi.import_anysplat_encoder(sd)))
    del want["vit.mask_token"]            # read and dropped by the port
    got = twi.import_anysplat_encoder(_torch(sd), tcfg.encoder)
    _assert_equal(got, want)
    # the depth configuration skips a point head (its import into the
    # point-head encoder is `test_torch_point_head.py`'s); another stray
    # key still raises
    _assert_equal(twi.import_anysplat_encoder(
        {**_torch(sd), "encoder.point_head.norm.weight": torch.zeros(1)},
        tcfg.encoder), want)
    with pytest.raises(KeyError, match="not consumed"):
        twi.import_anysplat_encoder(
            {**_torch(sd), "encoder.pose_head.norm.weight": torch.zeros(1)},
            tcfg.encoder)
    # the fabricator inverts the importer over the port's module
    enc = twi.build_module(lambda: Encoder(tcfg.encoder), got, device="cpu")
    back = tmf._fab_anysplat_encoder(enc)
    assert set(back) == set(sd) - {"encoder.track_head.x.weight"}
    for k, v in back.items():
        if not k.endswith("mask_token"):
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_wan_vae_import_matches_jax():
    jcfg = jvae.WanVAEConfig(**VAE, attn_scales=())
    tree = jax.eval_shape(lambda k: jvae.init(k, jcfg), jax.random.key(0))
    sd = _random_sd(_jax_fab(jmf._fab_wan_vae, tree), "wan_vae", 1)
    want = convert._subtree("vae", jax.tree_util.tree_map(
        np.asarray, jwi.import_wan_vae(sd, jcfg)))
    tcfg = tvae.WanVAEConfig(**VAE)
    halves = twi.import_wan_vae(_torch(sd), tcfg)
    _assert_equal({**halves["encoder"], **halves["decoder"]}, want)
    enc = twi.build_module(lambda: tvae.WanVAEEncoder(tcfg),
                           halves["encoder"], device="cpu")
    dec = twi.build_module(lambda: tvae.WanVAEDecoder(tcfg),
                           halves["decoder"], device="cpu")
    back = tmf._fab_wan_vae(enc, dec)
    assert set(back) == set(sd)
    for k, v in back.items():
        assert tuple(v.shape) == sd[k].shape, k     # the broadcast gammas
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_umt5_import_matches_jax():
    jcfg = jumt5.UMT5Config(**UMT5)
    tree = jax.eval_shape(lambda k: jumt5.init(k, jcfg), jax.random.key(0))
    sd = _random_sd(_jax_fab(jmf._fab_umt5, tree), "umt5", 2)
    want = convert._subtree("umt5", jax.tree_util.tree_map(
        np.asarray, jwi.import_umt5(sd, jcfg.num_layers)))
    tcfg = tumt5.UMT5Config(**UMT5)
    _assert_equal(twi.import_umt5(_torch(sd), tcfg), want)
    # without `shared.weight`, the tied copy is read, as in JAX
    tied = {("encoder.embed_tokens.weight" if k == "shared.weight" else k): v
            for k, v in sd.items()}
    _assert_equal(twi.import_umt5(_torch(tied), tcfg), want)
    back = tmf._fab_umt5(twi.build_module(
        lambda: tumt5.UMT5Encoder(tcfg), twi.import_umt5(_torch(sd), tcfg),
        device="cpu"))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


@pytest.fixture(scope="module")
def dit_sd():
    jcfg = jdit.WanDiTConfig(**DIT)
    tree = jax.eval_shape(lambda k: jdit.init(k, jcfg), jax.random.key(0))
    return _random_sd(_jax_fab(jmf._fab_wan_dit, tree), "wan_dit", 3)


def test_wan_dit_import_matches_jax(dit_sd):
    want = convert._subtree("dit", jax.tree_util.tree_map(
        np.asarray, jwi.import_wan_dit(dit_sd)))
    tcfg = tdit.WanDiTConfig(**DIT)
    # the depth comes from the keys, the widths from the config
    got = twi.import_wan_dit(_torch(dit_sd),
                             tdit.WanDiTConfig(**{**DIT, "num_layers": 7}))
    _assert_equal(got, want)
    back = tmf._fab_wan_dit(twi.build_module(lambda: tdit.WanDiT(tcfg), got,
                                             device="cpu"))
    assert set(back) == set(dit_sd)
    for k, v in back.items():
        assert tuple(v.shape) == dit_sd[k].shape, k
        np.testing.assert_array_equal(v.numpy(), dit_sd[k], err_msg=k)


def test_apply_peft_lora_matches_jax(dit_sd):
    rng = np.random.default_rng(4)
    d, r = DIT["dim"], 8
    lora = {}
    for layer, attn, proj in ((0, "attn1", "to_q"), (0, "attn2", "to_out.0"),
                              (1, "attn1", "to_k"), (1, "attn2", "to_v")):
        p = f"base_model.model.blocks.{layer}.{attn}.{proj}"
        lora[f"{p}.lora_A.weight"] = rng.standard_normal((r, d)) \
            .astype(np.float32)
        lora[f"{p}.lora_B.weight"] = rng.standard_normal((d, r)) \
            .astype(np.float32)
    want = convert._subtree("dit", jax.tree_util.tree_map(
        np.asarray, jwi.apply_peft_lora(jwi.import_wan_dit(dit_sd), lora)))
    base = twi.import_wan_dit(_torch(dit_sd), tdit.WanDiTConfig(**DIT))
    got = twi.apply_peft_lora(base, _torch(lora))
    merged = {f"blocks.0.attn1.q.weight", "blocks.0.attn2.o.weight",
              "blocks.1.attn1.k.weight", "blocks.1.attn2.v.weight"}
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.numpy()
        if k in merged:
            assert not np.array_equal(base[k].numpy(), v)
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                       atol=MERGE_RTOL * np.abs(v).max())
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    with pytest.raises(KeyError, match="not consumed"):
        twi.apply_peft_lora(base, {"base_model.model.blocks.0.attn1.to_q."
                                   "lora_C.weight": torch.zeros(1)})


@pytest.mark.parametrize("file_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", [
    DIT,                        # narrow, as the 1.3B
    dict(dim=80, ffn_dim=112, num_layers=4, num_heads=10, freq_dim=32,
         text_dim=24)])             # wider and deeper, as the 14B
def test_peft_merge_cast_per_site_is_the_cast_after(layout, file_dtype):
    """Each site merged in fp32 from the file's values and cast to bf16 at
    once (`dtype=`, what `load_generator` asks for) gives the module
    `build_module` makes from the fp32 merge, bit for bit, on bf16 and on
    fp32 files and an adapter on every site.  On fp32 files, merging into
    weights already cast to bf16 rounds twice and differs."""
    cfg = tdit.WanDiTConfig(**layout)
    gen = torch.Generator().manual_seed(9)
    base = {k: v.to(file_dtype) for k, v in twi.import_wan_dit(
        tmf._fab_wan_dit(tdit.init(cfg, gen, "cpu")), cfg).items()}
    adapter, r = {}, 8
    for i in range(cfg.num_layers):
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v", "to_out.0"):
                p = f"base_model.model.blocks.{i}.{attn}.{proj}"
                adapter[f"{p}.lora_A.weight"] = torch.randn(
                    r, cfg.dim, generator=gen) / cfg.dim ** 0.5
                adapter[f"{p}.lora_B.weight"] = torch.randn(
                    cfg.dim, r, generator=gen) * 1e-2
    fp32 = twi.apply_peft_lora(base, adapter)
    cast = twi.apply_peft_lora(base, adapter, dtype=torch.bfloat16,
                               device="cpu")
    merged = {k for k in cast if not torch.equal(cast[k].to(file_dtype),
                                                 base[k])}
    assert len(merged) == cfg.num_layers * 8
    assert all(fp32[k].dtype == torch.float32 for k in merged)
    assert all(cast[k].dtype == torch.bfloat16 for k in merged)
    want, got = (twi.build_module(lambda: tdit.WanDiT(cfg), sd, device="cpu",
                                  dtype=torch.bfloat16).state_dict()
                 for sd in (fp32, cast))
    assert want.keys() == got.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    twice = twi.apply_peft_lora({k: v.to(torch.bfloat16)
                                 for k, v in base.items()}, adapter,
                                dtype=torch.bfloat16)
    same = all(torch.equal(twice[k], got[k]) for k in merged)
    assert same == (file_dtype == torch.bfloat16)


# --------------------------------------------------------------------------- #
# the stitched checkpoint                                                     #
# --------------------------------------------------------------------------- #
K_CHOP = 2
R = 2


def stitched_checkpoint(tcfg, k_chop: int, seed: int) -> dict:
    """A reference-format `stitched_model_epoch_N.pth` dict for the tiny
    encoder chopped at `k_chop`: LoRA factors and biases (bias="lora_only")
    on every kept ViT block's qkv, every frame block's fc1, the camera
    modulation and DPT head convs (1×1, 3×3, 7×7), factors alone on a
    bias-free conv; the stitch conv and the three token tensors."""
    rng = np.random.default_rng(seed)
    enc = twi.encoder_skeleton(tcfg.encoder)
    modules = dict(enc.named_modules())
    vit_depth, agg_depth = tcfg.encoder.vit.depth, tcfg.encoder.agg.depth
    sites = [f"aggregator.patch_embed.blocks.{i}.attn.qkv"
             for i in range(vit_depth - k_chop)]
    sites += [f"aggregator.frame_blocks.{i}.mlp.fc1"
              for i in range(agg_depth)]
    sites += ["camera_head.poseLN_modulation.1", "depth_head.projects.0",
              "gaussian_param_head.scratch.refinenet1.resConfUnit1.conv1",
              "depth_head.scratch.output_conv2.2",
              "gaussian_param_head.input_merger.0",
              "depth_head.resize_layers.3", "depth_head.scratch.layer2_rn"]
    lora = {}
    for site in sites:
        port = twi.encoder_from_reference(site + ".", k_chop)[:-1]
        w = modules[port].weight
        k = w.shape[-1] if w.dim() == 4 else 1
        o, i = w.shape[0], w.shape[1]
        lora[f"encoder.{site}.lora_A"] = rng.standard_normal(
            (R * k, i * k)).astype(np.float32)
        lora[f"encoder.{site}.lora_B"] = rng.standard_normal(
            (o * k, R * k)).astype(np.float32) * 0.1
        if modules[port].bias is not None:
            lora[f"encoder.{site}.bias"] = rng.standard_normal(o) \
                .astype(np.float32)
    d = tcfg.encoder.vit.embed_dim
    cshape = (tcfg.conv.out_channels, tcfg.latent_channels, 5, 3, 3)
    return {"lora": lora,
            "stitching_layer": {
                "weight": rng.standard_normal(cshape).astype(np.float32),
                "bias": rng.standard_normal(cshape[0]).astype(np.float32)},
            "mask_token": rng.standard_normal((1, d)).astype(np.float32),
            "cls_token": rng.standard_normal((1, 1, d)).astype(np.float32),
            "register_tokens": rng.standard_normal(
                (1, tcfg.encoder.vit.num_register_tokens, d))
            .astype(np.float32)}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_stitched_checkpoint_lora_merge_matches_jax():
    """The counterpart of `test_cli_runs.py::
    test_lora_from_flat_stacked_rehydration`, over the whole encoder."""
    _, tcfg = _configs()
    # one set of base weights for both: the port's random init, written in
    # the reference's names and read by each package's importer
    enc = build_random(lambda: Encoder(tcfg.encoder), torch.Generator()
                       .manual_seed(0), "cpu", torch.float32)
    ref = {k: v.numpy() for k, v in tmf._fab_anysplat_encoder(enc).items()}
    params = jax.tree_util.tree_map(np.asarray,
                                    jwi.import_anysplat_encoder(ref))
    ck = stitched_checkpoint(tcfg, K_CHOP, 5)
    cfg = tlora.LoraConfig(r=R, alpha=4)
    # JAX: stacked factors with zero rows for the chopped blocks
    pieces = jwi.import_stitched_checkpoint(ck, vit_chop=K_CHOP)
    lt, bias = jlora.lora_from_flat(
        {k.removeprefix("encoder/"): v for k, v in pieces["lora"].items()},
        params)
    merged = jlora.merge_lora(jgraft(params, bias), lt,
                              jlora.LoraConfig(r=R, alpha=4))
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                          merged))
    # the port: per-block sites, none for a chopped block
    tp = twi.import_stitched_checkpoint(to_torch(ck), vit_chop=K_CHOP)
    flat = {k.removeprefix("encoder."): v for k, v in tp["lora"].items()}
    enc = twi.encoder_skeleton(tcfg.encoder)
    lora, biases = tlora.lora_from_flat(flat, enc)
    assert not any(s.startswith(f"vit.blocks.{i}.") for s in lora
                   for i in range(K_CHOP))
    assert f"vit.blocks.{K_CHOP}.attn.qkv" in lora
    base = twi.import_anysplat_encoder(_torch(ref), tcfg.encoder)
    got = tlora.merge_lora({**base, **biases}, lora, cfg)
    del want["vit.mask_token"]
    sites = {f"{s}.weight" for s in lora}
    kept = [k for k in want if not (k.startswith("vit.blocks.") and
                                    int(k.split(".")[2]) < K_CHOP)]
    for k in kept:
        w = want[k].numpy()
        if k in sites:
            assert not np.array_equal(base[k].numpy(), w), k
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=MERGE_RTOL * np.abs(w).max(),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert {k[:-5] for k in biases} == {s for s in lora
                                        if not s.endswith("layer_rn.1")}
    for name in ("mask_token", "cls_token", "register_tokens"):
        np.testing.assert_array_equal(tp["special"][name].numpy(),
                                      np.asarray(pieces["special"][name]))
    np.testing.assert_array_equal(tp["stitch_conv"]["weight"].numpy(),
                                  np.asarray(pieces["stitch_conv"]["kernel"]))

    stray = dict(ck, lora={**ck["lora"], "encoder.nowhere.lora_A":
                           np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="not consumed"):
        twi.import_stitched_checkpoint(to_torch(stray), vit_chop=K_CHOP)
    wrong = {"vit.blocks.3.attn.qkv": {"a": torch.zeros(5, 2),
                                       "b": torch.zeros(2, 3)}}
    with pytest.raises(ValueError, match="do not fit"):
        tlora.lora_from_flat(wrong, enc)
