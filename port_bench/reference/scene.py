"""The plain reference of one text→3DGS scene, in float32 (or, for the
control, in bf16 over fp8-rounded weights).

Built from the frozen copies in this folder (the port's modules as of the
benchmark's writing, every attention on plain math, the composite on its
plain version `composite_ref`, no tensor parallelism, no LoRA), so it
imports nothing of the program.  It takes the benchmark's inputs — the
seed's weights (`common.fill_weights`), the token ids, the noise — and
works every stage out again: the prompt embeddings, the UniPC chain with
CFG, the VAE video, the stitched decoder's Gaussians and cameras, the
orbit cameras, the rendered views and the PLY's fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import common
from port_bench.reference import chopped_anysplat as ca
from port_bench.reference import umt5 as umt5_mod
from port_bench.reference import unipc, wan_dit, wan_vae
from port_bench.reference.encoder import quantile
from port_bench.reference.gaussians import map_pdf_to_opacity
from port_bench.reference.splat_decoder import render

# the port's `pipelines/t23d.py` prompts (the reference's
# `inference_t23d.py:88-92`)
ORBIT_PROMPT_TEMPLATE = (
    "The camera rotates around the scene, maintaining constant distance: "
    "`{prompt}`. The orbiting trajectory captures 3D structure and "
    "consistency."
)
NEGATIVE_PROMPT = (
    "Background blur, Blurred background, Blurred scene, Artifacts, not "
    "aesthetic, not realistic, rendered noise, low quality movement, low "
    "quality video, low quality image, deformed, disfigured, distorted, "
    "extra limbs, cloned face, skinny, glitchy, double torso, extra arms, "
    "extra hands, mangled fingers, missing lips, ugly face, distorted legs, "
    "fused fingers, too many fingers, long neck"
)


@dataclasses.dataclass(frozen=True)
class Config:
    """The configuration file's `t23d` group, in the reference's types."""
    width: int = 512
    height: int = 512
    num_frames: int = 13
    num_inference_steps: int = 50
    guidance_scale: float = 5.0
    flow_shift: float = 3.0
    dit: wan_dit.WanDiTConfig = wan_dit.WanDiTConfig()
    umt5: umt5_mod.UMT5Config = umt5_mod.UMT5Config()
    vae: wan_vae.WanVAEConfig = wan_vae.WanVAEConfig()
    stitched: ca.StitchedConfig = ca.StitchedConfig()
    feedforward_size: int = 448

    @property
    def latent_shape(self) -> tuple:
        t_lat = (self.num_frames - 1) // 4 + 1
        return (1, 16, t_lat, self.height // 8, self.width // 8)


def config(t23d: dict, head_dtype: str = "float32") -> Config:
    cfg = common.from_dict(Config(), t23d)
    enc = dataclasses.replace(cfg.stitched.encoder, head_dtype=head_dtype)
    return dataclasses.replace(
        cfg, stitched=dataclasses.replace(cfg.stitched, encoder=enc))


MAKERS = {"umt5": lambda cfg: umt5_mod.UMT5Encoder(cfg.umt5),
          "dit": lambda cfg: wan_dit.WanDiT(cfg.dit),
          "vae": lambda cfg: wan_vae.WanVAEDecoder(cfg.vae),
          "stitched": lambda cfg: ca.StitchedDecoder(cfg.stitched)}


def build_one(cfg: Config, name: str, stream: common.WeightStream, device,
              dtype=torch.float32):
    """The reference's module `name` (the program's names: "umt5", "dit",
    "vae", "stitched"), in `dtype`, its weights the next ones of the
    seed's `stream`: build the parts in the program's order."""
    with torch.device("meta"):
        m = MAKERS[name](cfg)
    m = m.to(dtype).to_empty(device=device).eval().requires_grad_(False)
    stream.fill(name, m)
    return m


def build(cfg: Config, parts: tuple, seed: int, overrides: list,
          device, dtype=torch.float32) -> dict:
    """The reference's modules of `parts`, in that order, with the seed's
    weights, in `dtype`."""
    stream = common.WeightStream(seed, device, overrides)
    return {name: build_one(cfg, name, stream, device, dtype)
            for name in parts}


@torch.no_grad()
def fp8_round_weights(mods: dict) -> None:
    """The control's weights: every matrix and convolution kernel rounded
    to float8 e4m3 with one scale per output channel (its largest
    magnitude at 448, e4m3's largest finite value), kept in the modules'
    dtype."""
    for m in mods.values():
        for name, p in m.named_parameters():
            if p.ndim < 2:
                continue
            w = p.float()
            amax = w.abs().flatten(1).amax(1).clamp_min(1e-12)
            scale = (amax / 448.0).reshape(-1, *([1] * (w.ndim - 1)))
            q = (w / scale).to(torch.float8_e4m3fn).float() * scale
            p.copy_(q.to(p.dtype))


@torch.no_grad()
def embed(umt5, tokenize, prompt: str, device):
    """(cond, uncond) embeddings (1, L, d) in the weights' dtype."""
    out = []
    for text in (ORBIT_PROMPT_TEMPLATE.format(prompt=prompt),
                 NEGATIVE_PROMPT):
        ids, mask = (torch.as_tensor(np.asarray(a), device=device)
                     for a in tokenize(text))
        out.append(umt5_mod.encode(umt5, ids, mask))
    return out[0], out[1]


@torch.no_grad()
def denoise(dit, cond, uncond, cfg: Config, latents0: torch.Tensor):
    """UniPC with CFG over the DiT in its weights' dtype; sampler state
    fp32."""
    dt = dit.patch_embedding.weight.dtype

    def dit_apply(x, ts, text):
        return wan_dit.forward(dit, x.to(dt), ts, text.to(dt)).float()

    model_fn = unipc.cfg_model(dit_apply, cond, uncond, cfg.guidance_scale)
    ucfg = unipc.UniPCConfig(num_steps=cfg.num_inference_steps,
                             shift=cfg.flow_shift)
    return unipc.sample_scan(model_fn, latents0.float(), ucfg)


@torch.no_grad()
def mask_and_opacities(out, conf_threshold: float, dtype=torch.float32):
    """The confidence mask and the opacities that the decoder's assembly
    makes from `out`'s own depth confidence and raw Gaussian features: the
    pixels whose confidence lies above its `conf_threshold` quantile, and
    map_pdf_to_opacity(sigmoid(the first feature)) on them, 0 elsewhere;
    computed in `dtype` (bf16: the control's assembly), opacities returned
    as (B, G) fp32."""
    conf = out.depth_conf.to(dtype)
    mask = conf > quantile(conf.float().flatten(), conf_threshold).to(dtype)
    b = conf.shape[0]
    pdf = torch.sigmoid(out.anchor_feats[:, :, 0].to(dtype))
    opacities = map_pdf_to_opacity(pdf).reshape(b, -1) * mask.reshape(b, -1)
    return mask, opacities.float()


def resize_half_pixel(video: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, T, H, W) → (B, C, T, size, size), half-pixel linear,
    antialiased when it shrinks (the port's `resize_trilinear_half_pixel`)."""
    b, c, t, h, w = video.shape
    out = F.interpolate(video.reshape(b, c * t, h, w), size=(size, size),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(b, c, t, size, size)


@torch.no_grad()
def decode(vae, stitched, latents_norm: torch.Tensor, cfg: Config, device):
    """Normalised latent → (EncoderOutput, video (1, 3, T, H, W) fp32)."""
    dt = next(vae.parameters()).dtype
    latents = wan_vae.unnormalize_latents(latents_norm.float())
    video = wan_vae.decode(vae, latents.to(dt)).float()
    ff = resize_half_pixel(video, cfg.feedforward_size)
    out = ca.forward_with_latent(stitched, latents, ff, cfg.stitched,
                                 device=device)
    return out, video


def interpolate_cameras(extrinsics_c2w, intrinsics_norm, t: int):
    """The orbit's cameras: t in-between cameras per adjacent pair (lerped
    translation and intrinsics, SVD-orthogonalised lerped rotations),
    numpy float64, as the port's `io/video_export.py`."""
    ex = np.asarray(extrinsics_c2w, np.float64)
    kk = np.asarray(intrinsics_norm, np.float64)
    b, v = ex.shape[:2]
    out_e, out_k = [], []
    for i in range(v - 1):
        out_e.append(ex[:, i])
        out_k.append(kk[:, i])
        for j in range(1, t + 1):
            alpha = j / (t + 1)
            rot = (1 - alpha) * ex[:, i, :3, :3] + alpha * ex[:, i + 1, :3, :3]
            u, _, vt = np.linalg.svd(rot)
            rot = u @ vt
            trans = (1 - alpha) * ex[:, i, :3, 3] + alpha * ex[:, i + 1, :3, 3]
            e = np.broadcast_to(np.eye(4), (b, 4, 4)).copy()
            e[:, :3, :3] = rot
            e[:, :3, 3] = trans
            out_e.append(e)
            out_k.append((1 - alpha) * kk[:, i] + alpha * kk[:, i + 1])
    out_e.append(ex[:, -1])
    out_k.append(kk[:, -1])
    return (np.stack(out_e, 1).astype(np.float32),
            np.stack(out_k, 1).astype(np.float32))


@torch.no_grad()
def render_views(out, views, size: int, orbit_t: int, device, *,
                 bf16: bool = False):
    """The orbit views `views` of the decoder's Gaussians: (color (V, 3,
    H, W) in [0, 1], depth (V, H, W)).  bf16: the Gaussians and cameras
    rounded to bf16 first (the control's render)."""
    def cast(x):
        return x.to(torch.bfloat16).float() if bf16 else x.float()
    ex, kk = interpolate_cameras(cast(out.extrinsic_c2w).cpu().numpy(),
                                 cast(out.intrinsic_norm).cpu().numpy(),
                                 orbit_t)
    g = out.gaussians
    g = g._replace(**{f: cast(getattr(g, f)) for f in
                      ("means", "covariances", "harmonics", "opacities")})
    idx = list(views)
    r = render(g, torch.from_numpy(ex[:, idx]), torch.from_numpy(kk[:, idx]),
               (size, size), device=device)
    return r.color[0], r.depth[0]


def ply_fields(g) -> np.ndarray:
    """The (G, 17) float32 rows the port's PLY export writes for batch
    entry 0: x y z, zero normals, the DC band, opacity, log scales, wxyz
    quaternions."""
    def host(x):
        return x[0].detach().float().cpu().numpy()
    means, scales, rot = host(g.means), host(g.scales), host(g.rotations)
    f_dc, op = host(g.harmonics[..., 0]), host(g.opacities)
    rot = rot / np.maximum(np.linalg.norm(rot, axis=-1, keepdims=True), 1e-12)
    rot_wxyz = np.concatenate([rot[:, 3:4], rot[:, :3]], axis=-1)
    cols = [means, np.zeros_like(means), f_dc, op[:, None],
            np.log(np.maximum(scales, 1e-20)), rot_wxyz]
    return np.concatenate(cols, axis=1).astype(np.float32)


def load_ply(path) -> np.ndarray:
    """A binary little-endian float32 PLY → its (G, n_properties) rows."""
    with open(path, "rb") as f:
        n = None
        names = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names += 1
            elif line == "end_header":
                break
        return np.frombuffer(f.read(), np.float32).reshape(n, names)
