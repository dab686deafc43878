"""The encoder's point-head branch (`pred_head_type="point"`) of the port
against the JAX package's.

  * `dpt_apply`'s activations ("inv_log", "norm_exp", "linear", "exp" with
    "expp1", "expp0", "sigmoid" confidences), on the small heads of
    `tests/test_torch_heads.py`, JAX `init` weights through `convert`:
    within 1e-4 of each output's largest magnitude (the cascade's fp32
    sums in another order; the activations run in fp32 on both sides).
  * The whole tiny encoder of `tests/test_torch_slice.py` with a point head
    (the JAX package's own case, `tests/test_stitched_model.py::
    test_point_head_branch`), fp32: points, depth, confidences, cameras and
    Gaussians within 1e-3 of each output's range (a dozen blocks, two DPT
    cascades and a camera refinement, each summing in its own order);
    opacities where both confidence masks agree; the depth the points' z
    exactly.
  * The importer and the fabricator: a tiny reference state dict with a
    point head (the JAX fabricator's keys, random values from a numpy
    seed) imports into the point-head encoder equal to JAX's import +
    `convert`, exactly; the depth configuration skips the head; the
    fabricator gives the file back; at the deployed widths VGGT-1B's point
    head passes the manifest gate (which checks it whole) and fills the
    module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_heads import DIM_IN, IMG, PSI, B, S, _taps
from test_torch_slice import CAMERA_BIAS, _configs
from vist3a_tpu.io import manifests as jmf
from vist3a_tpu.io import weight_import as jwi
from vist3a_tpu.nn import encoder as jenc
from vist3a_tpu.nn import heads as jh
from vist3a_tpu_torch import convert
from vist3a_tpu_torch.io import manifests as tmf
from vist3a_tpu_torch.io import weight_import as twi
from vist3a_tpu_torch.nn import encoder as tenc
from vist3a_tpu_torch.nn import heads as th

CASCADE_RTOL = 1e-4
ENCODER_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_to_range(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    span = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rtol * span


def _point_cfg(mod, **kw):
    return mod.DPTConfig(dim_in=DIM_IN, features=16,
                         out_channels=(8, 16, 16, 16), head2_features=8,
                         frames_chunk_size=2, **kw)


@pytest.mark.parametrize("activation,conf,out", [
    ("inv_log", "expp1", 4), ("norm_exp", "expp0", 4),
    ("linear", "sigmoid", 4), ("exp", "expp1", 2)])
def test_dpt_activations_equal_jax(rng, activation, conf, out):
    kw = dict(activation=activation, conf_activation=conf, output_dim=out)
    cfg_j, cfg_t = _point_cfg(jh, **kw), _point_cfg(th, **kw)
    params = jh.dpt_init(jax.random.key(5), cfg_j)
    taps = _taps(rng)
    want = jh.dpt_apply(params, [jnp.asarray(t) for t in taps], (IMG, IMG),
                        PSI, cfg_j, (B, S))
    head = th.DPTHead(cfg_t)
    head.load_state_dict(convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    got = th.dpt_apply(head, [torch.from_numpy(t) for t in taps], (IMG, IMG),
                       PSI, cfg_t, (B, S))
    assert got[0].shape == (B, S, IMG, IMG, out - 1)
    for g, w in zip(got, want):
        _close_to_range(g, w, CASCADE_RTOL)


def _point_configs():
    jcfg, tcfg = _configs()
    over = dict(dim_in=2 * 32, features=16, out_channels=(8, 16, 16, 16),
                head2_features=8, activation="inv_log",
                conf_activation="expp1", output_dim=4)
    je = dataclasses.replace(jcfg.encoder, pred_head_type="point",
                             point=jh.DPTConfig(**over))
    te = dataclasses.replace(tcfg.encoder, pred_head_type="point",
                             point=th.DPTConfig(**over))
    return je, te


@pytest.fixture(scope="module")
def point_encoders():
    je, te = _point_configs()
    params = jenc.init(jax.random.key(0), je)
    params["camera_head"]["pose_branch"]["fc2"]["b"] = jnp.asarray(
        CAMERA_BIAS)
    assert "point_head" in params
    enc = convert.load_jax_encoder_params(
        tenc.Encoder(te, vit_start=0),
        jax.tree_util.tree_map(np.asarray, params))
    return je, te, params, enc.requires_grad_(False)


def test_point_encoder_forward_equals_jax(point_encoders):
    je, te, params, enc = point_encoders
    images = np.random.default_rng(3).uniform(0, 1, (1, 3, 3, IMG, IMG)) \
        .astype(np.float32)
    want = jax.jit(lambda p, x: jenc.forward(p, x, je))(
        params, jnp.asarray(images))
    with torch.no_grad():
        got = tenc.forward(enc, torch.from_numpy(images), te, remat=False)
    g = 3 * IMG * IMG
    assert got.gaussians.means.shape == (1, g, 3)
    assert got.depth.shape == (1, 3, IMG, IMG, 1)
    # the depth is the points' z, the confidence the point head's (> 1)
    np.testing.assert_array_equal(
        _np(got.depth[..., 0]).reshape(-1),
        _np(got.gaussians.means[..., 2]).reshape(-1))
    assert float(got.depth_conf.min()) > 1.0
    for name in ("depth", "depth_conf", "extrinsic_c2w", "intrinsic_norm",
                 "scene_scale"):
        _close_to_range(getattr(got, name), getattr(want, name),
                        ENCODER_RTOL)
    for name in ("means", "covariances", "harmonics"):
        _close_to_range(getattr(got.gaussians, name),
                        getattr(want.gaussians, name), ENCODER_RTOL)
    agree = _np(got.conf_valid_mask) == np.asarray(want.conf_valid_mask)
    assert agree.mean() > 0.99
    keep = agree.reshape(1, -1)
    np.testing.assert_allclose(_np(got.gaussians.opacities)[keep],
                               _np(want.gaussians.opacities)[keep],
                               rtol=0, atol=ENCODER_RTOL)


def _random_file(tree, seed):
    exp = {}
    jmf._fab_anysplat_encoder(tree, exp)
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(tuple(s)).astype(np.float32)
            for k, s in sorted(exp.items())}


def test_point_head_import_and_fabrication_round_trip():
    je, te = _point_configs()
    tree = jax.eval_shape(lambda k: jenc.init(k, je), jax.random.key(0))
    sd = _random_file(tree, 11)
    assert any(k.startswith("encoder.point_head.") for k in sd)
    want = convert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jwi.import_anysplat_encoder(sd)))
    del want["vit.mask_token"]            # read and dropped by the port
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = twi.import_anysplat_encoder(tsd, te)
    assert set(got) == set(want)
    assert any(k.startswith("point_head.") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    # the depth configuration skips the point head (its path never reads it)
    depth_cfg = dataclasses.replace(te, pred_head_type="depth")
    plain = twi.import_anysplat_encoder(tsd, depth_cfg)
    assert set(plain) == {k for k in want if not k.startswith("point_head.")}
    # the point configuration needs one
    with pytest.raises(KeyError, match="left unset"):
        twi.import_anysplat_encoder(
            {k: v for k, v in tsd.items() if "point_head" not in k}, te)
    # the fabricator inverts the importer, point head included
    enc = twi.build_module(lambda: tenc.Encoder(te), got, device="cpu")
    back = tmf._fab_anysplat_encoder(enc)
    assert set(back) == set(sd)
    for k, v in back.items():
        if not k.endswith("mask_token"):
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_deployed_point_head_passes_the_manifest_gate():
    """VGGT-1B's point head at the deployed widths (meta device, free): the
    gate accepts it whole and refuses a part of it; the importer fills the
    point-head encoder from it."""
    point = tenc.EncoderConfig(pred_head_type="point")
    exp = {k: tuple(v.shape) for k, v in tmf._fab_anysplat_encoder(
        twi.encoder_skeleton(point)).items()}
    head = {k: s for k, s in exp.items() if k.startswith("encoder.point_head.")}
    assert exp["encoder.point_head.scratch.output_conv2.2.weight"] == \
        (4, 32, 1, 1)
    assert len(head) == len([k for k in exp
                             if k.startswith("encoder.depth_head.")])
    sd = tmf.fabricate_from(exp)
    assert tmf.validate_state_dict(sd, "anysplat_encoder")
    got = twi.import_anysplat_encoder(sd, point)
    assert set(got) == set(twi.encoder_skeleton(point).state_dict())
    part = dict(sd)
    part.pop("encoder.point_head.scratch.output_conv1.weight")
    with pytest.raises(ValueError, match="1 missing"):
        tmf.validate_state_dict(part, "anysplat_encoder")
    part = {**sd, "encoder.point_head.scratch.output_conv2.2.weight":
            torch.zeros(2, 32, 1, 1)}
    with pytest.raises(ValueError, match="1 shape mismatches"):
        tmf.validate_state_dict(part, "anysplat_encoder")
    # without a point head the file is the JAX manifest's, as before
    depth = tmf.fabricate_from(tmf.load_manifest("anysplat_encoder"))
    assert tmf.validate_state_dict(depth, "anysplat_encoder")
