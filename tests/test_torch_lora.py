"""The port's LoRA against the JAX package's `stitch/lora.py`.

Sites, merges and the trainable bias set are compared on the tiny stitched
config of `test_torch_slice.py` (chop at 2), with JAX `init` weights and
factors carried over by `convert`.  Every merge uses random nonzero B
factors: the zero-init B makes a merge at init an exact no-op.  Merged
weights agree within 1e-6 of each weight's largest magnitude: both sides
add scaling·(a@b) in fp32, the products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _configs
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.stitch import chopped_anysplat as jca
from vist3a_tpu.stitch import lora as jlora
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.nn import encoder as tenc
from vist3a_tpu_torch.stitch import lora as tlora
from vist3a_tpu_torch.train import stitching as tst

K_CHOP = 2
MERGE_RTOL = 1e-6


@pytest.mark.parametrize("spec", ["r64,a32,d0.0,f0", "r8,a16,d0.1,bnone,f1",
                                  "r4,a8,tqkv|proj,enc,fix_head",
                                  " r2 , a4 ,, ball"])
def test_parse_lora_mode_matches_jax(spec):
    ours, theirs = tlora.parse_lora_mode(spec), jlora.parse_lora_mode(spec)
    assert vars(ours) == vars(theirs)
    assert ours.scaling == theirs.scaling


@pytest.mark.parametrize("spec", ["x5", "bsome", "r", "r4,q2"])
def test_parse_lora_mode_errors_match_jax(spec):
    for mod in (tlora, jlora):
        with pytest.raises(ValueError):
            mod.parse_lora_mode(spec)


@pytest.fixture(scope="module")
def jax_tree():
    jcfg, tcfg = _configs()
    params = {"encoder": jenc.init(jax.random.key(0), jcfg.encoder),
              "stitch_conv": jca.init_stitch_conv(jax.random.key(1), jcfg)}
    return jcfg, tcfg, params


def _random_b(lora_tree, seed):
    """The LoRA tree with every B factor drawn N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(lora_tree)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1)
        if getattr(path[-1], "key", None) == "b" else x
        for path, x in leaves])


def test_lora_sites_match_jax(jax_tree):
    """The student's sites (chopped) and the teacher's (whole encoder) are
    the JAX package's, per block; the DPT resize0/resize1 transposed convs
    are not sites; `jax_path` gives the JAX path of each."""
    _, tcfg, params = jax_tree
    cfg = jlora.LoraConfig(r=2)
    jsites = jlora.lora_sites(params["encoder"], cfg)
    lora = jlora.init_lora(jax.random.key(1), params["encoder"], cfg)
    student = tst.student_skeleton(tcfg)
    assert set(tlora.lora_sites(student, cfg)) == \
        set(convert.lora_from_jax(jax.tree_util.tree_map(np.asarray, lora),
                                  K_CHOP))
    with torch.device("meta"):
        teacher = tenc.Encoder(tcfg.encoder, vit_start=0)
    tsites = tlora.lora_sites(teacher, cfg)
    assert {f"encoder.{s}" for s in tsites} == set(convert.lora_from_jax(
        jax.tree_util.tree_map(np.asarray, lora), None))
    assert {tlora.jax_path(s) for s in tsites} == \
        {"/".join(map(str, p)) for p, _, _ in jsites}
    assert not any("resize0" in s or "resize1" in s for s in tsites)
    assert "vit.patch_proj" in tsites
    targeted = tlora.parse_lora_mode("r2,tqkv|out_conv")
    assert set(tlora.lora_sites(teacher, targeted)) == {
        s for s in tsites if "qkv" in s or "out_conv" in s}


# one node of each JAX site kind, with its factors' shapes (r = 2)
KINDS = {
    "linear": ({"w": (6, 10), "b": (10,)}, (6, 2), (2, 10)),
    "stacked_linear": ({"w": (3, 6, 10)}, (3, 6, 2), (3, 2, 10)),
    "conv": ({"kernel": (7, 5, 3, 3), "bias": (7,)}, (15, 6), (6, 21)),
    # a transposed conv's (k, k, c_out, c_in) kernel
    "conv_hwio": ({"kernel_hwio": (2, 2, 4, 6)}, (8, 4), (4, 12)),
    "conv_mat3": ({"kernel_mat3": (45, 7), "bias": (7,)}, (15, 6), (6, 21)),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_merge_of_each_site_kind_matches_jax(kind):
    node_shapes, a_shape, b_shape = KINDS[kind]
    rng = np.random.default_rng(3)
    node = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
            for k, s in node_shapes.items()}
    factors = {"a": jnp.asarray(rng.standard_normal(a_shape), jnp.float32),
               "b": jnp.asarray(rng.standard_normal(b_shape), jnp.float32)}
    key = "blocks" if kind == "stacked_linear" else "site"
    cfg = jlora.LoraConfig(r=2, alpha=4)
    merged = jlora.merge_lora({key: node}, {key: factors}, cfg)
    want = convert.from_jax_params({"encoder": merged})
    base = convert.from_jax_params({"encoder": {key: node}})
    lora = convert.lora_from_jax({key: factors}, None)
    got = tlora.merge_lora(base, lora, tlora.LoraConfig(r=2, alpha=4))
    assert set(got) == set(want)
    changed = 0
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=0,
                                   atol=MERGE_RTOL * w.abs().max().item())
        changed += not torch.equal(got[name], base[name])
    assert changed == (3 if kind == "stacked_linear" else 1)


def test_merge_of_the_whole_encoder_matches_jax(jax_tree):
    """Every site of the tiny encoder (stacked ViT, aggregator and camera
    trunk linears, the camera head's linears, the patch embedding conv and
    every DPT `kernel_mat<k>` conv) merged with random B factors."""
    _, _, params = jax_tree
    cfg = jlora.LoraConfig(r=2, alpha=4)
    lora = _random_b(jlora.init_lora(jax.random.key(1), params["encoder"],
                                     cfg), 4)
    merged = jlora.merge_lora(params["encoder"], lora, cfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    want = convert.from_jax_params({"encoder": to_np(merged)})
    base = convert.from_jax_params({"encoder": to_np(params["encoder"])})
    got = tlora.merge_lora(base, convert.lora_from_jax(to_np(lora), None),
                           tlora.LoraConfig(r=2, alpha=4))
    moved = 0
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=0,
                                   atol=MERGE_RTOL * w.abs().max().item())
        moved += not torch.equal(got[name], base[name])
    assert moved == len(convert.lora_from_jax(to_np(lora), None))


def test_lora_bias_predicate_matches_jax(jax_tree):
    """The biases bias="lora_only" trains: those of the sites, on the
    student's names (the JAX tree's, without the chopped blocks and the
    patch embedding, which the student does not hold)."""
    _, tcfg, params = jax_tree
    cfg = jlora.LoraConfig(r=2)
    jpred = jlora.lora_bias_predicate(params, cfg)
    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jpred(tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)) for path, _ in paths])
    flags = convert.from_jax_params(jax.tree_util.tree_map(
        lambda m, x: np.full(np.shape(x), m), marked, params))
    want = {n for n, f in flags.items() if bool(f.all())
            and convert._student_holds(n, K_CHOP)}
    student = tst.student_skeleton(tcfg)
    tpred = tlora.lora_bias_predicate(student, cfg)
    got = {n for n, _ in student.named_parameters() if tpred(n)}
    assert got == want and len(got) > 50
