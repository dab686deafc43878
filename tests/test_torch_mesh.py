"""The port's multi-GPU layer in one process: `core/mesh.py`'s layout and
draws, `core/distributed.py` without a launcher, the mesh flags against
the JAX parsers, the TP layouts against JAX's `param_shardings`, and that
`train_stitching.main` lets go of what it loaded.  The spawned 2×2 world
is `test_torch_multiprocess.py`'s."""

import gc
import sys
import types
import weakref

import numpy as np
import pytest
import torch

from vist3a_tpu.cli import arguments as jarg
from vist3a_tpu.core import mesh as jmesh
from vist3a_tpu.nn import qwen_vl as jqwen
from vist3a_tpu.nn import wan_dit as jdit
from vist3a_tpu_torch.cli import arguments as targ
from vist3a_tpu_torch.core import distributed
from vist3a_tpu_torch.core import mesh as tmesh
from vist3a_tpu_torch.nn import qwen_vl as tqwen
from vist3a_tpu_torch.nn import wan_dit as tdit

import torch_mp_world as W


def test_mesh_config_resolves_and_errors_as_jax():
    """`tests/test_core.py:10-17`: -1 takes the devices the model axis
    leaves; a layout off the device count raises the same error."""
    for cfg in ((-1, 1), (-1, 2), (4, 2), (8, 1)):
        assert tmesh.MeshConfig(*cfg).resolve(8) == \
            jmesh.MeshConfig(*cfg).resolve(8)
    for cfg in ((3, 2), (-1, 3), (2, 2)):
        with pytest.raises(ValueError) as mine:
            tmesh.MeshConfig(*cfg).resolve(8)
        with pytest.raises(ValueError) as theirs:
            jmesh.MeshConfig(*cfg).resolve(8)
        assert str(mine.value) == str(theirs.value)


def test_single_process_mesh():
    """Without a launcher: no group, a 1×1 mesh whose collectives are
    no-ops, and a model axis of 2 refused as JAX refuses it on one
    device."""
    assert not distributed.launched()
    assert distributed.setup_dist("cpu") is False
    assert (distributed.get_rank(), distributed.get_world_size()) == (0, 1)
    assert distributed.is_main_process()
    distributed.barrier()
    distributed.cleanup()
    mesh = tmesh.create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    assert not tmesh.active(mesh) and mesh.group("data") is None
    g = [torch.ones(3)]
    tmesh.average_gradients(g, mesh)
    tmesh.reduce_lora_grads(g, mesh, tensor_parallel=True)
    assert torch.equal(g[0], torch.ones(3))
    with pytest.raises(ValueError, match="does not match 1 devices"):
        tmesh.create_mesh(tmesh.MeshConfig(model=2))


@pytest.mark.parametrize("name, argv", [
    ("stitching_training_argument", ["--mesh_data", "4", "--mesh_model",
                                     "2"]),
    ("training_vdm_argument", ["--dit_sharding", "tp"]),
    ("training_vdm_argument", ["--mesh_data", "4", "--mesh_model", "2",
                               "--dit_sharding", "tp_fsdp"]),
    ("inference_vist3a_argument", ["--checkpoint_path", "c",
                                   "--transformer_lora_path", "l",
                                   "--input_texts_path", "p",
                                   "--mesh_model", "8"]),
])
def test_mesh_flags_parse_as_jax(name, argv):
    """`tests/test_mesh_cli.py:235-264`."""
    mine = getattr(targ, name)().parse_args(argv)
    theirs = getattr(jarg, name)().parse_args(argv)
    for k in ("mesh_data", "mesh_model", "dit_sharding"):
        assert getattr(mine, k, None) == getattr(theirs, k, None), k
    with pytest.raises(SystemExit):
        getattr(targ, name)().parse_args(argv + ["--dit_sharding", "zero"])


def test_local_batch_size_and_rows():
    """Each process loads its per-device batch; a global-batch draw keeps
    this rank's rows, and on one rank it is the plain draw."""
    mesh = tmesh.Mesh(data=4, model=2, rank=5)
    assert (mesh.data_index, mesh.model_index) == (2, 1)
    assert tmesh.local_batch_size(3, mesh) == 3
    assert (tmesh.data_index(mesh), tmesh.data_size(mesh)) == (2, 4)
    assert (tmesh.data_index(None), tmesh.data_size(None)) == (0, 1)
    full = torch.randn((8, 5), generator=torch.Generator().manual_seed(1))
    rows = tmesh.randn_rows((2, 5), torch.Generator().manual_seed(1), mesh)
    assert torch.equal(rows, full[4:6])
    assert torch.equal(tmesh.local_rows(full, mesh), full[4:6])
    one = tmesh.randn_rows((2, 5), torch.Generator().manual_seed(1), None)
    assert torch.equal(one, torch.randn(
        (2, 5), generator=torch.Generator().manual_seed(1)))
    u = tmesh.rand_rows((2,), torch.Generator().manual_seed(2), mesh)
    assert torch.equal(u, torch.rand(
        8, generator=torch.Generator().manual_seed(2))[4:6])


def test_place_dit_names():
    dit = tdit.init(tdit.WanDiTConfig(**W.DIT), torch.Generator(), "cpu")
    for how in tmesh.DIT_SHARDINGS:
        assert tmesh.place_dit(dit, dit.cfg, tmesh.create_mesh(), how) \
            is dit and dit.tp is None
    with pytest.raises(ValueError) as mine:
        tmesh.place_dit(dit, dit.cfg, None, "zero")
    with pytest.raises(ValueError) as theirs:
        jmesh.place_dit({}, None, None, "zero")
    assert str(mine.value) == str(theirs.value)


def _spec_dim(spec, ndim: int):
    """The dim a JAX PartitionSpec shards over "model" (the stacked layer
    axis dropped), or None."""
    parts = list(spec)[1:] + [None] * ndim
    return next((d for d in range(ndim) if parts[d] == "model"), None)


def test_dit_tp_slices_follow_jax_param_shardings():
    """Each block weight's split dim is JAX's `param_shardings` (weights
    (in, out) there, (out, in) here; the qk-norm scales are replicated
    there and follow their heads here)."""
    specs = jdit.param_shardings(jdit.WanDiTConfig(**W.DIT))["blocks"]
    dit = tdit.WanDiT(tdit.WanDiTConfig(**W.DIT))
    state = dict(dit.named_parameters())
    sliced = tdit.tp_slices(state, 2, 1)
    for name, t in state.items():
        got = [d for d in range(t.ndim) if sliced[name].shape[d] != t.shape[d]]
        if not name.startswith("blocks."):
            assert got == [], name
            continue
        *path, leaf = name.split(".")[2:]
        spec = specs
        for k in path:
            spec = spec[k]
        if leaf in ("norm_q", "norm_k"):
            assert got == [0], name
            continue
        if leaf in ("weight", "bias") and path[-1] in ("q", "k", "v", "o",
                                                       "fc1", "fc2"):
            jdim = _spec_dim(spec["w" if leaf == "weight" else "b"],
                             t.ndim)
            want = [] if jdim is None else [t.ndim - 1 - jdim]
            assert got == want, name
        else:
            assert got == [], name
    q = "blocks.0.attn1.q.weight"
    assert torch.equal(sliced[q], state[q][24:48])


def test_judge_tp_slices_follow_jax_text_param_shardings():
    cfg = tqwen.QwenVLTextConfig(**W.TEXT)
    model = tqwen.QwenVLText(cfg)
    state = dict(model.named_parameters())
    sliced = tqwen.text_tp_slices(state, 2, 0)
    specs = jqwen.text_param_shardings({"lm_head": 0}, None)["layers"]
    names = {"q": specs["q"], "k": specs["k"], "v": specs["v"],
             "o": specs["o"], "gate": specs["mlp"]["gate"],
             "up": specs["mlp"]["up"], "down": specs["mlp"]["down"]}
    for name, t in state.items():
        got = [d for d in range(t.ndim) if sliced[name].shape[d] != t.shape[d]]
        parts = name.split(".")
        if parts[0] != "layers" or parts[-2] not in names:
            assert got == [], name
            continue
        spec = names[parts[-2]]["w" if parts[-1] == "weight" else "b"]
        jdim = _spec_dim(spec, t.ndim)
        assert got == ([] if jdim is None else [t.ndim - 1 - jdim]), name


class _KeepingWandb(types.ModuleType):
    """A `wandb` whose `init` fails after keeping the frames of its
    callers, as a logger that records what its failed start saw does."""

    def __init__(self):
        super().__init__("wandb")
        self.kept = []

    def init(self, **kwargs):
        frame = sys._getframe(1)
        while frame is not None:
            self.kept.append(frame)
            frame = frame.f_back
        raise RuntimeError("no API key")


def test_stitching_main_lets_go_of_its_modules(tmp_path, monkeypatch):
    """Once `train_stitching.main` returns, the teacher and the VAE can be
    garbage-collected, though a failed wandb start keeps its callers'
    frames: the modules are loaded in `_train`, below the logger's start.
    (Loaded in `main`'s own frame before the logger, they stayed allocated
    for the rest of the process on the card.)"""
    from vist3a_tpu_torch.cli import model_loading as ml
    from vist3a_tpu_torch.cli import train_stitching as cli
    from vist3a_tpu_torch.data import loader as loader_mod
    from vist3a_tpu_torch.nn import wan_vae
    from vist3a_tpu_torch.train import stitching as tst

    scfg = W.stitched_config()
    refs = {}

    def encoder(root, cfg, device):
        m = W._encoder(cfg, torch.Generator().manual_seed(0))
        refs["teacher"] = weakref.ref(m)
        return m

    def vae(root, cfg, halves, device):
        m = wan_vae.init_encoder(scfg.vae, torch.Generator().manual_seed(1),
                                 device=device)
        refs["vae"] = weakref.ref(m)
        return {"encoder": m}
    fake = _KeepingWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setattr(ml, "load_anysplat_encoder", encoder)
    monkeypatch.setattr(ml, "load_wan_vae", vae)
    monkeypatch.setattr(ml, "stitched_config", lambda args: scfg)
    monkeypatch.setattr(ml, "weights_root", lambda args: tmp_path)
    monkeypatch.setattr(tst, "VIEW_COUNTS", (W.STITCH_VIEWS,))
    monkeypatch.setattr(loader_mod, "create_stitching_dataloader",
                        lambda *a, **k: (W.stitch_batches(slice(0, 1))[:1],
                                         None))
    args = targ.stitching_training_argument().parse_args(
        ["--dataset", f"dl3dv:{tmp_path}", "--num_epochs", "1",
         "--lora_config", "r2,a4,d0.0,f0", "--save_path", str(tmp_path),
         "--wandb_logging"])
    with pytest.warns(UserWarning, match="wandb.init failed"):
        state, history = cli.main(args, device="cpu")
    assert state.step == 1 and np.isfinite(history[0]["total_loss"])
    assert fake.kept, "the stand-in wandb was not started"
    del state, history
    gc.collect()
    assert refs.keys() == {"teacher", "vae"}
    assert all(r() is None for r in refs.values()), \
        {k: r() is not None for k, r in refs.items()}


def test_inference_run_peers_denoise_and_write_nothing(tmp_path,
                                                       monkeypatch):
    """A tensor-parallel peer of the writing rank (`writes=False`) embeds
    and denoises each of its prompts with its model group, and decodes and
    writes nothing; the writing rank runs whole requests."""
    from vist3a_tpu_torch.cli import inference_t23d as tinf
    from vist3a_tpu_torch.pipelines import t23d as tt

    calls = []
    monkeypatch.setattr(tt, "embed_prompts", lambda umt5, tok, prompt,
                        **kw: calls.append(("embed", prompt)) or (0, 1))
    monkeypatch.setattr(tt, "denoise", lambda dit, cond, uncond, cfg, **kw:
                        calls.append(("denoise", cond, uncond)))
    monkeypatch.setattr(tt, "text_to_3dgs", lambda *a, **kw:
                        calls.append(("request",)) or "res")
    monkeypatch.setattr(tinf, "summarize", lambda res: res)
    modules = {"umt5": None, "dit": None}
    prompts = ["a", "b", "c"]
    out = tinf.run(modules, None, prompts, str(tmp_path), tt.T23DConfig(),
                   process_index=0, process_count=2, writes=False,
                   device="cpu")
    assert out == [] and list(tmp_path.iterdir()) == []
    assert calls == [("embed", "a"), ("denoise", 0, 1), ("embed", "c"),
                     ("denoise", 0, 1)]
    calls.clear()
    out = tinf.run(modules, None, prompts, str(tmp_path), tt.T23DConfig(),
                   process_index=0, process_count=2, device="cpu")
    assert [p for p, _ in out] == ["a", "c"] and calls == [("request",)] * 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a", "c"]
