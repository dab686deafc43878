"""The text side of the port's reward against the JAX package's: the CLIP
tokenizer (`data/clip_tokenizer.py`), the CLIP text towers, the four
reference importers of `nn/clip.py`, the `pickscore` / `dfn5b` fabricators
of `io/manifests.py` and `cli/train_vdm.py::build_reward_fns`.

  * Tokenizer: ids equal to the JAX tokenizer's (which splits with the
    `regex` package; the port scans by hand) on the vocabulary of
    `tests/test_clip_tokenizer.py`, over text with non-ASCII letters and
    digits (`²`, `Ⅻ`, `½`, Arabic-Indic digits), mojibake and HTML
    entities, both pad modes and truncation; the pre-tokens equal
    `regex.findall` of the JAX pattern on a seeded fuzz set.
  * Text features at the tiny configs of `tests/test_cli_rl.py`, JAX
    `text_init` weights through `convert`: within 1e-5 of the largest
    (fp32 both sides, sums in another order).
  * Importers: a tiny HF `CLIPModel`'s state dict and its open_clip
    relayout (`test_cli_rl._oc_layout`), through the JAX importer and
    `convert` and through the port's importer: equal exactly in fp32 (an
    import is a rename, a transpose and a split).
  * `expected_keys` of both families over meta-device modules equals the
    committed manifests; the fabricators invert the importers.
  * `build_reward_fns` on a tiny scorer root (`test_cli_rl.scorer_root`):
    the text features and the reward loss within 1e-5 of the JAX
    function's (loss: 1e-5 of its magnitude).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli_rl import RCFG, TINY_TEXT, TINY_VIS, _oc_layout  # noqa: F401
from test_cli_rl import scorer_root  # noqa: F401  (fixture)
from test_clip_tokenizer import MERGES, build_vocab
from vist3a_tpu.cli import train_vdm as jvdm_cli
from vist3a_tpu.data import clip_tokenizer as jtok
from vist3a_tpu.nn import clip as jclip
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.cli import train_vdm as tvdm_cli
from vist3a_tpu_torch.data import clip_tokenizer as ttok
from vist3a_tpu_torch.io import manifests as tmf
from vist3a_tpu_torch.io import weight_import as twi
from vist3a_tpu_torch.nn import clip as tclip
from vist3a_tpu_torch.train import reward as trew

FEAT_RTOL = 1e-5
STRINGS = [
    "a photo of a cat",
    "The THE the",
    "it's a 3d render, isn't it? THEY'LL've",
    "hello,   world!!  123",
    "the cat's hat -- photo #42 (render)",
    "",
    "café Ölçü naïve straße İstanbul ſ's 'ſ",
    "x² + y³ = Ⅻ ½ ٣٤ ⁴⁄₅ 中文字符 日本語",
    "cafÃ© â€œquotedâ€\x9d &amp; &lt;tag&gt; &amp;amp;",
    "tabs\tand\nnewlines\x1cand\x1fseparators　ideographic",
    "<|startoftext|>inside<|endoftext|>",
    "antidisestablishmentarianism",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("tok")
    (d / "vocab.json").write_text(json.dumps(build_vocab(MERGES)),
                                  encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n",
        encoding="utf-8")
    (d / "bpe_simple_vocab_16e6.txt").write_text(
        "header\n" + "\n".join(" ".join(m) for m in MERGES) + "\n",
        encoding="utf-8")
    files = (str(d / "vocab.json"), str(d / "merges.txt"))
    openai = str(d / "bpe_simple_vocab_16e6.txt")
    # the HF pair wins over the merges file in `_clip_tokenizer_from_dir`
    return {"files": (tvdm_cli._clip_tokenizer_from_dir(d),
                      jtok.CLIPTokenizer.from_files(*files)),
            "openai": (ttok.CLIPTokenizer.from_openai_merges(openai),
                       jtok.CLIPTokenizer.from_openai_merges(openai))}


@pytest.mark.parametrize("layout", ["files", "openai"])
def test_tokenizer_ids_match_jax(tokenizers, layout):
    mine, theirs = tokenizers[layout]
    for s in STRINGS:
        assert ttok.fix_text(s) == jtok.fix_text(s), s
        assert mine.encode(s) == theirs.encode(s), s
        for pad in ("eos", "zero"):
            for n in (6, 77):
                got, want = mine([s, s[::-1]], n, pad=pad), \
                    theirs([s, s[::-1]], n, pad=pad)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    assert mine.decode(mine.encode(STRINGS[0])) == \
        theirs.decode(theirs.encode(STRINGS[0]))


def test_pre_tokens_are_the_regex_split():
    """`_pre_tokens` against `regex.findall` of the JAX pattern, and the
    whitespace clean against `regex.sub`, on seeded fuzz strings over
    letters, numbers, marks, spaces, separators and the literals."""
    import regex

    rnd = random.Random(0)
    pool = list("abcSTdefſ'’ \t\n\x1c\x1f\x85!?.,-0123456789²½Ⅻ一éÉßİ<|>"
                "́　٣") + ["<|startoftext|>", "<|endoftext|>",
                                    "'s", "'LL", "'ſ", "'RE"]
    for _ in range(3000):
        s = "".join(rnd.choice(pool) for _ in range(rnd.randint(0, 16)))
        assert ttok._pre_tokens(s) == regex.findall(jtok._PAT, s), repr(s)
        assert ttok._whitespace_clean(s) == jtok._whitespace_clean(s), \
            repr(s)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_text_features_match_jax(tokenizers, act):
    import dataclasses

    jcfg = dataclasses.replace(TINY_TEXT, act=act)
    tcfg = tclip.CLIPTextConfig(**dataclasses.asdict(jcfg))
    params = jclip.text_init(jax.random.key(5), jcfg)
    model = convert.load_jax_clip_text_params(
        tclip.CLIPText(tcfg), jax.tree_util.tree_map(np.asarray, params))
    tok = tokenizers["files"][0]
    for pad in ("eos", "zero"):
        ids = tok(STRINGS[:4], jcfg.context_length, pad=pad)
        want = np.asarray(jclip.text_features(params, jnp.asarray(ids), jcfg))
        with torch.no_grad():
            got = tclip.text_features(model, torch.from_numpy(ids)).numpy()
        assert got.shape == want.shape == (4, jcfg.projection_dim)
        assert np.abs(got - want).max() <= FEAT_RTOL * np.abs(want).max()
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-6)


def test_random_text_init_matches_jax_shapes():
    tcfg = tclip.CLIPTextConfig(**{k: getattr(TINY_TEXT, k) for k in (
        "hidden_size", "num_layers", "num_heads", "mlp_dim", "vocab_size",
        "context_length", "projection_dim", "act")})
    model = tclip.text_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = convert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jclip.text_init(jax.random.key(0), TINY_TEXT)))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert float(got["pos_embed"].std()) == pytest.approx(0.01, rel=0.2)
    for name in ("CLIP_H_TEXT", "CLIP_L_TEXT", "LONGCLIP_L_TEXT"):
        import dataclasses

        assert dataclasses.asdict(getattr(tclip, name)) == \
            dataclasses.asdict(getattr(jclip, name))


def _hf_state():
    from test_cli_rl import _hf_clip_model

    sd = {k: v.detach().numpy() for k, v in
          _hf_clip_model().state_dict().items() if "position_ids" not in k}
    return sd, _oc_layout(sd)


@pytest.mark.parametrize("importer,layout,tower", [
    ("import_hf_clip_vision", "hf", "vision"),
    ("import_open_clip_vision", "open_clip", "vision"),
    ("import_hf_clip_text", "hf", "text"),
    ("import_open_clip_text", "open_clip", "text")])
def test_importers_match_jax(importer, layout, tower):
    hf, oc = _hf_state()
    sd = hf if layout == "hf" else oc
    n = TINY_TEXT.num_layers
    jtree = getattr(jclip, importer)(sd, n)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jtree))
    if tower == "vision":
        want["patch"] = torch.from_numpy(
            np.asarray(jtree["patch"]).transpose(3, 2, 0, 1).copy())
    got = getattr(tclip, importer)({k: torch.from_numpy(v)
                                    for k, v in sd.items()}, n)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k].contiguous(), want[k]), k
    # and the port's module takes it strictly
    cfg = (tclip.CLIPVisionConfig(**{f: getattr(TINY_VIS, f) for f in (
        "hidden_size", "num_layers", "num_heads", "mlp_dim", "patch_size",
        "image_size", "projection_dim", "act")}) if tower == "vision"
        else tclip.CLIPTextConfig(**{f: getattr(TINY_TEXT, f) for f in (
            "hidden_size", "num_layers", "num_heads", "mlp_dim",
            "vocab_size", "context_length", "projection_dim", "act")}))
    cls = tclip.CLIPVision if tower == "vision" else tclip.CLIPText
    twi.build_module(lambda: cls(cfg), got, device="cpu")


@pytest.mark.parametrize("family", ["pickscore", "dfn5b"])
def test_expected_keys_equal_the_manifest(family):
    assert tmf.expected_keys(family) == tmf.load_manifest(family)


@pytest.mark.parametrize("family", ["pickscore", "dfn5b"])
def test_fabricators_invert_the_importers(family):
    """A random tiny vision and text tower → the family's reference state
    dict → the importers → the same values; the keys and shapes are the
    JAX fabricator's at the same tiny configs."""
    from vist3a_tpu.io import manifests as jmf

    gen = torch.Generator().manual_seed(3)
    vcfg = tclip.CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=4,
                                  mlp_dim=64, patch_size=8, image_size=32,
                                  projection_dim=16)
    tcfg = tclip.CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=4,
                                mlp_dim=64, vocab_size=50, context_length=16,
                                projection_dim=16)
    vision = tclip.init(vcfg, gen, "cpu")
    text = tclip.text_init(tcfg, gen, "cpu")
    if family == "pickscore":
        sd = tmf._fab_hf_clip_model(vision, text, torch.tensor(4.6))
        back_v = tclip.import_hf_clip_vision(sd, 2)
        back_t = tclip.import_hf_clip_text(sd, 2)
    else:
        sd = tmf._fab_dfn5b(vision, text)
        back_v = tclip.import_open_clip_vision(sd, 2)
        back_t = tclip.import_open_clip_text(sd, 2)
    for module, back in ((vision, back_v), (text, back_t)):
        own = module.state_dict()
        assert own.keys() == back.keys()
        assert all(torch.equal(own[k], back[k]) for k in own)

    jv = jax.eval_shape(lambda k: jclip.init(k, jclip.CLIPVisionConfig(
        **{f: getattr(vcfg, f) for f in ("hidden_size", "num_layers",
                                          "num_heads", "mlp_dim",
                                          "patch_size", "image_size",
                                          "projection_dim")})),
        jax.random.key(0))
    jt = jax.eval_shape(lambda k: jclip.text_init(k, jclip.CLIPTextConfig(
        hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64, vocab_size=50,
        context_length=16, projection_dim=16)), jax.random.key(1))
    want = {}
    if family == "pickscore":
        jmf._fab_hf_clip_vision(jv, want)
        jmf._fab_hf_clip_text(jt, want)
        want["logit_scale"] = ("size", 1)
    else:
        jmf._fab_open_clip(jv, want, visual=True)
        jmf._fab_open_clip(jt, want, visual=False)
    got = {k: ("size", v.numel()) if want.get(k, (None,))[0] == "size"
           else tuple(v.shape) for k, v in sd.items()}
    assert got == want


def test_build_reward_fns_matches_jax(scorer_root):  # noqa: F811
    """The counterpart of `test_build_reward_fns_text_parity`: the port's
    per-prompt features and reward loss on the tiny scorer root against
    the JAX function's."""
    root, _ = scorer_root
    jloss, jtext = jvdm_cli.build_reward_fns(root, rcfg=RCFG,
                                             text_cfg=TINY_TEXT)
    vis = tclip.CLIPVisionConfig(**{f: getattr(TINY_VIS, f) for f in (
        "hidden_size", "num_layers", "num_heads", "mlp_dim", "patch_size",
        "image_size", "projection_dim", "act")})
    txt = tclip.CLIPTextConfig(**{f: getattr(TINY_TEXT, f) for f in (
        "hidden_size", "num_layers", "num_heads", "mlp_dim", "vocab_size",
        "context_length", "projection_dim", "act")})
    tloss, ttext = tvdm_cli.build_reward_fns(
        root, rcfg=trew.RewardConfig(pick_cfg=vis, pe_cfg=vis), text_cfg=txt,
        device="cpu")
    for prompt in ("a photo of a cat", "ein Foto, 3½ Katzen"):
        want = [np.asarray(f) for f in jtext(prompt)]
        got = ttext(prompt)
        assert ttext(prompt) is got                  # cached per prompt
        for g, w in zip(got, want):
            assert g.shape == w.shape == (1, 16) and not g.requires_grad
            assert np.abs(g.numpy() - w).max() <= FEAT_RTOL * np.abs(w).max()
    im = np.random.default_rng(0).uniform(-1, 1, (2, 3, 40, 40)) \
        .astype(np.float32)
    want, _, _ = jloss(jnp.asarray(im), pick_text=jnp.asarray(want[0]),
                       pe_text=jnp.asarray(want[1]))
    with torch.no_grad():
        got, _, _ = tloss(torch.from_numpy(im), pick_text=got[0],
                          pe_text=got[1])
    assert abs(float(got) - float(want)) <= FEAT_RTOL * abs(float(want))
