"""OFFLINE pyiqa → npz conversion for the MUSIQ-SPAQ scorer.

Port of `vist3a_tpu/eval/musiq_convert.py`.  The reference scores imaging
quality with pyiqa's MUSIQ
(`evaluation/gen_eval/gen_metrics/imaging_quality.py:32-62`); conversion
of the published `musiq_spaq_ckpt-*.pth` is a ONE-TIME step on a machine
where pyiqa is installed.  It writes two files:

  1. `musiq_spaq.npz`        — the weights in `eval/musiq.py`'s layout (the
                               JAX package's: either package reads it;
                               `load_musiq_npz` checks every key and shape);
  2. `musiq_transcript.json` — pyiqa's own scores on deterministic
                               synthetic images (seeded numpy), the numeric
                               anchor `verify_transcript` compares with.

Procedure (offline machine):

    python -m vist3a_tpu_torch.eval.musiq_convert --out_dir /path/out
    python -m vist3a_tpu_torch.eval.musiq_convert --out_dir /path/out --verify

`convert_state_dict` maps pyiqa's names by pattern, each field trying the
known spellings of its module, with a shape check on every tensor; a miss
raises with the full key manifest (`dump_manifest`).  It is numpy only, as
in the JAX package, and returns the JAX package's parameter tree.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from vist3a_tpu_torch.eval.musiq import MUSIQConfig


def synthetic_images(n: int = 4, seed: int = 0):
    """Deterministic [0,1] float32 HWC images shared by the transcript
    recorder (offline, pyiqa) and the in-repo comparison."""
    rng = np.random.default_rng(seed)
    sizes = [(224, 224), (384, 512), (448, 448), (512, 384)][:n]
    out = []
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 0.5 + 0.25 * np.sin(xx / (8 + i)) * np.cos(yy / (11 + i))
        img = np.stack([base,
                        np.clip(base + 0.1 * np.sin(yy / 17), 0, 1),
                        np.clip(base - 0.1 * np.cos(xx / 13), 0, 1)], -1)
        img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1)
        out.append(img.astype(np.float32))
    return out


def dump_manifest(state_dict) -> str:
    return "\n".join(f"{k}  {tuple(v.shape)}"
                     for k, v in sorted(state_dict.items()))


def convert_state_dict(sd: dict, cfg: MUSIQConfig = MUSIQConfig()) -> dict:
    """pyiqa torch state dict → the `eval/musiq.py` param tree.

    Mapping is by NAME PATTERN with hard shape asserts; torch Linear
    weights (out, in) transpose to our (in, out).  Adjust `_KEY_MAP` if
    pyiqa renames modules — every miss raises with the manifest so a
    mis-wire cannot pass silently (and `verify_transcript` numerically
    re-checks the result)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def take(names, shape, transpose=False):
        """Pop the first present alias; loud-fail with the manifest."""
        if isinstance(names, str):
            names = (names,)
        for name in names:
            if name in sd:
                v = sd.pop(name)
                if transpose:
                    v = np.ascontiguousarray(v.T)
                if tuple(v.shape) != tuple(shape):
                    raise ValueError(
                        f"{name}: shape {v.shape} != expected {shape}")
                return v
        raise KeyError(
            f"none of the pyiqa aliases {list(names)!r} found; manifest:\n"
            + dump_manifest(sd))

    d, m = cfg.hidden, cfg.mlp_dim

    def linear(prefixes, i, o):
        if isinstance(prefixes, str):
            prefixes = (prefixes,)
        return {"w": take([f"{p}.weight" for p in prefixes], (i, o),
                          transpose=True),
                "b": take([f"{p}.bias" for p in prefixes], (o,))}

    def ln(prefixes):
        if isinstance(prefixes, str):
            prefixes = (prefixes,)
        return {"scale": take([f"{p}.weight" for p in prefixes], (d,)),
                "bias": take([f"{p}.bias" for p in prefixes], (d,))}

    # _KEY_MAP: alias spellings per field.  pyiqa's musiq_arch.py ports the
    # google-research/musiq JAX release; the module spelling has drifted
    # across pyiqa versions, so each field tries the known candidates
    # (encoderblock_{i} à la the JAX param tree, encoder_layers.{i} à la
    # plain torch ports) — the take() asserts remain the safety net, and
    # `verify_transcript` numerically re-checks the result.
    BLOCK_PREFIXES = ("transformer.encoder_layers.{i}",
                      "transformer_encoder.encoderblock_{i}",
                      "transformer.encoderblock_{i}",
                      "transformer_encoder.transformer_block.{i}")
    ATTN = (".self_attention", ".attention", ".msa", ".attn")
    LN1 = (".layer_norm_input", ".layernorm_input", ".ln1", ".norm1")
    LN2 = (".layer_norm_out", ".layernorm_out", ".ln2", ".norm2",
           ".layer_norm_mlp")
    MLP = (".mlp_block", ".mlp", ".mlpblock")

    def expand(i, suffixes):
        return [b.format(i=i) + s for b in BLOCK_PREFIXES for s in suffixes]

    blocks = []
    for i in range(cfg.num_layers):
        qkv = np.concatenate(
            [take(expand(i, [a + ".query.weight" for a in ATTN]), (d, d),
                  True),
             take(expand(i, [a + ".key.weight" for a in ATTN]), (d, d),
                  True),
             take(expand(i, [a + ".value.weight" for a in ATTN]), (d, d),
                  True)], axis=1)
        qkv_b = np.concatenate(
            [take(expand(i, [a + ".query.bias" for a in ATTN]), (d,)),
             take(expand(i, [a + ".key.bias" for a in ATTN]), (d,)),
             take(expand(i, [a + ".value.bias" for a in ATTN]), (d,))])
        blocks.append({
            "ln1": ln(expand(i, LN1)),
            "qkv": {"w": qkv, "b": qkv_b},
            "proj": {"w": take(expand(i, [a + ".out.weight" for a in ATTN]
                                      + [a + ".proj.weight" for a in ATTN]),
                               (d, d), True),
                     "b": take(expand(i, [a + ".out.bias" for a in ATTN]
                                      + [a + ".proj.bias" for a in ATTN]),
                               (d,))},
            "ln2": ln(expand(i, LN2)),
            "fc1": linear(expand(i, [p + ".fc1" for p in MLP]), d, m),
            "fc2": linear(expand(i, [p + ".fc2" for p in MLP]), m, d),
        })
    params = {
        "patch_proj": linear(("transformer.embedding",
                              "transformer_encoder.embedding",
                              "embedding", "patch_embedding"),
                             cfg.patch_dim, d),
        "cls": take(("transformer.cls_token", "transformer_encoder.cls",
                     "cls_token", "transformer.cls"), (1, 1, d)),
        "hse": take(("transformer.position_embedding",
                     "transformer_encoder.posembed_input.position_emb",
                     "posembed_input.position_emb",
                     "transformer.posembed_input.position_emb"),
                    (cfg.hse_grid, cfg.hse_grid, d)),
        "scale_embed": take(("transformer.scale_embedding",
                             "transformer_encoder.scale_emb.scale_emb",
                             "scale_emb.scale_emb",
                             "transformer.scale_emb.scale_emb"),
                            (cfg.num_scales, d)),
        "blocks": blocks,
        "ln_out": ln(("transformer.encoder_norm",
                      "transformer_encoder.encoder_norm", "encoder_norm",
                      "norm")),
        "head": linear(("head", "fc", "classifier", "mlp_head"), d, 1),
    }
    leftover = [k for k in sd if "num_batches" not in k]
    if leftover:
        raise ValueError(f"unmapped pyiqa keys remain: {leftover[:10]}")
    return params


def record_transcript(out_dir: Path) -> None:
    """OFFLINE: score the synthetic images with pyiqa itself and save the
    numbers — the external numeric anchor for `tests/test_musiq.py`."""
    import pyiqa           # offline machine only
    import torch

    metric = pyiqa.create_metric("musiq-spaq")
    scores = []
    for img in synthetic_images():
        t = torch.from_numpy(img).permute(2, 0, 1)[None]
        scores.append(float(metric(t)))
    (out_dir / "musiq_transcript.json").write_text(json.dumps({
        "pyiqa_metric": "musiq-spaq",
        "images": "vist3a_tpu_torch.eval.musiq_convert.synthetic_images()",
        "scores": scores,
    }, indent=1))
    sd = {k: v.cpu() for k, v in metric.net.state_dict().items()}
    from vist3a_tpu_torch.eval.musiq import save_musiq_npz
    save_musiq_npz(out_dir / "musiq_spaq.npz", convert_state_dict(sd))


def verify_transcript(npz_path, transcript_path, atol: float = 0.5, *,
                      device: str = "cuda") -> None:
    """IN-REPO: run the converted weights through `eval/musiq.py` on the
    same synthetic images and compare to the recorded pyiqa scores."""
    from vist3a_tpu_torch.eval.musiq import load_musiq_npz, make_musiq_scorer

    scorer = make_musiq_scorer(load_musiq_npz(npz_path, device=device))
    rec = json.loads(Path(transcript_path).read_text())
    for img, want in zip(synthetic_images(), rec["scores"]):
        got = scorer([img]) * 100.0      # scorer reports mean/100
        if abs(got - want) > atol:
            raise AssertionError(
                f"MUSIQ transcript mismatch: got {got:.3f}, pyiqa recorded "
                f"{want:.3f} (atol {atol})")
    print(f"MUSIQ transcript verified: {len(rec['scores'])} scores "
          f"within {atol}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out_dir", type=Path, required=True)
    ap.add_argument("--verify", action="store_true",
                    help="verify an existing npz+transcript pair in-repo "
                         "instead of converting (no pyiqa needed)")
    a = ap.parse_args()
    if a.verify:
        verify_transcript(a.out_dir / "musiq_spaq.npz",
                          a.out_dir / "musiq_transcript.json")
    else:
        a.out_dir.mkdir(parents=True, exist_ok=True)
        record_transcript(a.out_dir)
