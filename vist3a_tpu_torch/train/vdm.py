"""Reward-aligned VDM fine-tuning: LoRA on the Wan DiT, a flow-matching SFT
loss plus a truncated-rollout reward rendered through the stitched decoder.

Port of `vist3a_tpu/train/vdm.py` (the reference's `train_vdm.py`), on one
device or over a `core/mesh.py` mesh with the DiT placed by `place_dit`:
  * PEFT LoRA r8 α16 on q/k/v/o of attn1 and attn2 only (:370-388), the
    factors keyed `blocks.<i>.<site>` and merged per block inside the
    DiT's recompute (`nn/wan_dit.forward`);
  * AdamW β (0.9, 0.95), eps 1e-8, decoupled weight decay (:392-397), the
    global gradient norm clipped to 1.0 as optax clips it, and the update
    skipped when that norm is not finite (:641-644);
  * the SFT branch (:541-563): a bf16 VAE encode of the clip over fp32
    weights, a posterior sample, normalised, the flow-matching batch and
    loss through the LoRA'd DiT (`diffusion/flow_match.py`);
  * the RL branch (:566-637): a rollout length in [10, 50] (50 every 10th
    step; bucketed up to a multiple of 10, as the JAX package buckets it),
    guidance ~ U(4, 6), two drawn steps plus the last; the rollout in the
    index form — a no-grad recorded UniPC rollout, one batched
    differentiable re-evaluation of the K chosen steps (B = 2·K), a
    zero-valued gradient-carrying delta added onto the recorded outputs
    (a duplicate index counts once) and the affine replay — then the bf16
    VAE decode with recompute and the reward (`train/reward.py`);
  * an fp32 EMA of the LoRA factors, decay 0.99 with warm-up (:433-437);
  * the camera-motion prompt augmentation (:140-245), verbatim.

The JAX package's `backprop_mask` rollout form is its test oracle; the
port's tests hold the index form against both JAX forms instead of porting
it.  The JAX package draws from `fold_in` keys; here every draw comes from
a generator seeded from (seed, step, purpose) (`fold_seed`), other numbers
than JAX's, and `vdm_train_step` takes them as `draws` where a test must
feed both packages the same ones.  The SFT and reward losses are
differentiated one after the other (their gradients add up to the JAX
step's gradient of their sum), so the SFT branch's residuals are freed
before the rollout runs.

On a mesh the SFT draws (the posterior and flow noise, σ) are made for
the global batch and sliced to this rank's rows; the rollout's draws are
the same on every rank, as the JAX package replicates the rollout's
inputs.  The LoRA factors live outside the DiT, so FSDP2 reduces none of
their gradients: `core/mesh.py::reduce_lora_grads` does, before the
global norm and the clip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from vist3a_tpu_torch.core import mesh as mesh_mod
from vist3a_tpu_torch.diffusion import flow_match, unipc
from vist3a_tpu_torch.nn import wan_dit, wan_vae
from vist3a_tpu_torch.stitch import chopped_anysplat as ca
from vist3a_tpu_torch.stitch import lora as lora_mod
from vist3a_tpu_torch.train import ema as ema_mod
from vist3a_tpu_torch.train.reward import calculate_reward
from vist3a_tpu_torch.train.stitching import fold_seed, global_norm

# PEFT target set (`train_vdm.py:370-388`): q/k/v/out of both attention
# blocks, as the DiT's module paths
VDM_LORA_TARGETS = ("attn1/q", "attn1/k", "attn1/v", "attn1/o",
                    "attn2/q", "attn2/k", "attn2/v", "attn2/o")
VDM_LORA_SPEC = "r8,a16,d0.0,f0,t" + "|".join(VDM_LORA_TARGETS)
# purposes of the per-step draws (the JAX package's fold_in constants)
_STEPS, _INDICES, _GUIDANCE = 1, 2, 3
_VAE, _FLOW, _NOISE, _REWARD = 4, 5, 6, 7


@dataclasses.dataclass(frozen=True)
class VDMTrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    betas: tuple = (0.9, 0.95)           # `train_vdm.py:392-397`
    grad_clip: float = 1.0
    lora_spec: str = VDM_LORA_SPEC
    ema_decay: float = 0.99
    enable_rl: bool = True
    rollout_steps_low: int = 10
    rollout_steps_high: int = 50
    # the JAX package buckets the drawn length up to a multiple of this (its
    # compile cache); the reference draws the exact length.  Kept for
    # parity; 0 disables it.
    rollout_step_bucket: int = 10
    flow_shift: float = 3.0              # `train_vdm.py:337-343`

    @property
    def lora(self) -> lora_mod.LoraConfig:
        return lora_mod.parse_lora_mode(self.lora_spec)


@dataclasses.dataclass
class VDMTrainState:
    step: int
    lora: dict          # {site: {"a", "b"}} nn.Parameters, fp32
    optimizer: torch.optim.AdamW
    ema: dict           # {"<site>.a" / "<site>.b": fp32 shadow}


def flat_lora(lora: dict) -> dict[str, torch.Tensor]:
    return {f"{s}.{k}": f[k] for s, f in lora.items() for k in ("a", "b")}


def build_optimizer(lora: dict, cfg: VDMTrainConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(list(flat_lora(lora).values()),
                             lr=cfg.learning_rate, betas=cfg.betas, eps=1e-8,
                             weight_decay=cfg.weight_decay)


def init_train_state(generator: torch.Generator, dit: wan_dit.WanDiT,
                     cfg: VDMTrainConfig) -> VDMTrainState:
    """The LoRA factors of the DiT's sites (a drawn with `generator`, b
    zero), AdamW over them and their EMA shadow.  The DiT itself is frozen
    and shared: nothing of it is copied.  The factors take the sites' full
    shapes: make the state before a tensor-parallel placement."""
    if dit.tp is not None:
        raise ValueError("init_train_state reads the sites' full shapes: "
                         "make the state before placing the DiT "
                         "tensor-parallel")
    lora = lora_mod.init_lora(dit, cfg.lora, generator)
    return VDMTrainState(0, lora, build_optimizer(lora, cfg),
                         ema_mod.init_ema(flat_lora(lora)))


# --------------------------------------------------------------------------- #
# synced randomness: every host draws the same from (seed, step)              #
# --------------------------------------------------------------------------- #
def _generator(seed: int, step: int, purpose: int,
               device: torch.device | str = "cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        fold_seed(seed, step, purpose))


def choose_and_sync_steps(seed: int, step: int, low: int = 10,
                          high: int = 50) -> int:
    """`train_vdm.py:117-137` and the every-10th-step = high rule
    (:567-570)."""
    if step % 10 == 0:
        return high
    g = _generator(seed, step, _STEPS)
    return int(torch.randint(low, high + 1, (), generator=g))


def choose_and_sync_two_indices(seed: int, step: int, n: int) -> list[int]:
    """`train_vdm.py:100-114`: two distinct step indices in [0, n)."""
    g = _generator(seed, step, _INDICES)
    return [int(i) for i in torch.randperm(n, generator=g)[:2]]


def bucket_rollout_steps(n: int, bucket: int, high: int) -> int:
    """The drawn length rounded up to a multiple of `bucket`, at most
    `high`; an index drawn against the raw length stays valid."""
    if not bucket:
        return n
    return min(-(-n // bucket) * bucket, high)


def choose_guidance_scale(seed: int, step: int) -> float:
    """U(4, 6) (`train_vdm.py:580`)."""
    g = _generator(seed, step, _GUIDANCE)
    return float(4.0 + 2.0 * torch.rand((), generator=g))


# --------------------------------------------------------------------------- #
# truncated-rollout generation                                                #
# --------------------------------------------------------------------------- #
def rollout(dit: wan_dit.WanDiT, latents0: torch.Tensor, cond: torch.Tensor,
            uncond: torch.Tensor, *, num_steps: int, guidance_scale: float,
            backprop_idx, flow_shift: float = 3.0, lora: dict | None = None,
            lora_cfg: lora_mod.LoraConfig | None = None) -> torch.Tensor:
    """UniPC CFG rollout with gradient truncation (`train_vdm.py:586-623`),
    the JAX package's index form: the DiT input is detached every step and
    the gradient flows only through the chosen steps' model outputs (the
    last step among them) and the affine chain.  backprop_idx: (K,) step
    indices; a repeated index contributes once.  Returns the normalised
    final latents (fp32).

    The DiT computes in its weights' dtype (bf16 deployed), the sampler
    state stays fp32."""
    dt = dit.patch_embedding.weight.dtype
    ucfg = unipc.UniPCConfig(num_steps=num_steps, shift=flow_shift)

    def guided(x2, ts, text):
        v = wan_dit.forward(dit, x2.to(dt), ts, text.to(dt), remat=True,
                            lora=lora, lora_cfg=lora_cfg).float()
        v_c, v_u = v.chunk(2, dim=0)
        return v_u + guidance_scale * (v_c - v_u)

    def model_fn(x, t):
        x2 = torch.cat([x, x], dim=0)
        ts = torch.as_tensor(t, dtype=torch.float32,
                             device=x.device).expand(x2.shape[0])
        return guided(x2, ts, torch.cat([cond, uncond], dim=0))

    # 1. the no-grad rollout, recording each step's model input and output
    _, x_stack, v_stack = unipc.sample_scan_record(model_fn, latents0, ucfg)

    # 2. one batched differentiable re-evaluation of the K chosen steps
    idx = torch.as_tensor(backprop_idx, dtype=torch.long,
                          device=latents0.device)
    k, b0 = idx.shape[0], latents0.shape[0]
    _, timesteps = unipc.flow_sigmas(num_steps, flow_shift,
                                     ucfg.num_train_timesteps)
    x_sel = x_stack[idx]                                  # (K, B0, ...)
    xk = x_sel.reshape((k * b0,) + latents0.shape[1:])
    t_sel = torch.from_numpy(timesteps).to(latents0.device)[idx]
    ts1 = t_sel.repeat_interleave(b0)
    text = torch.cat([cond.repeat(k, 1, 1), uncond.repeat(k, 1, 1)], dim=0)
    v_sel = guided(torch.cat([xk, xk], dim=0), torch.cat([ts1, ts1]),
                   text).reshape(x_sel.shape)

    # a duplicate index (the forced last step may repeat a drawn one) keeps
    # one gradient term: its later rows carry none
    dup = torch.triu(idx[None, :] == idx[:, None], diagonal=1).any(0)
    keep = (~dup).to(v_sel.dtype).reshape((k,) + (1,) * (v_sel.dim() - 1))
    # zero-valued, gradient-carrying: the replay's value is the recorded
    # rollout's, its gradient flows through the K re-evaluations
    delta = keep * (v_sel - v_sel.detach())
    v_diff = v_stack.index_add(0, idx, delta)

    # 3. the affine replay with the K rows spliced in
    return unipc.replay_affine(v_diff, latents0, ucfg)


# --------------------------------------------------------------------------- #
# the train step                                                              #
# --------------------------------------------------------------------------- #
def draw_step(seed: int, step: int, cfg: VDMTrainConfig, rl: bool) -> dict:
    """The step's rollout length (bucketed), backprop indices (the two
    drawn and the forced last) and guidance scale."""
    if not rl:
        return {"num_steps": 0, "backprop_idx": [],
                "guidance": choose_guidance_scale(seed, step)}
    n = choose_and_sync_steps(seed, step, cfg.rollout_steps_low,
                              cfg.rollout_steps_high)
    drawn = choose_and_sync_two_indices(seed, step, n)
    n = bucket_rollout_steps(n, cfg.rollout_step_bucket,
                             cfg.rollout_steps_high)
    return {"num_steps": n, "backprop_idx": drawn + [n - 1],
            "guidance": choose_guidance_scale(seed, step)}


def vdm_train_step(state: VDMTrainState, dit: wan_dit.WanDiT,
                   vae_encoder: wan_vae.WanVAEEncoder,
                   vae_decoder: wan_vae.WanVAEDecoder,
                   stitched: ca.StitchedDecoder, *, video: torch.Tensor,
                   sft_text: torch.Tensor, rl_cond: torch.Tensor,
                   rl_uncond: torch.Tensor,
                   reward_loss_fn: Callable | None, seed: int,
                   scfg: ca.StitchedConfig, cfg: VDMTrainConfig,
                   latent_shape=(1, 16, 4, 64, 64), render_size: int = 448,
                   pair_budget: int | None = None, reward_text=None,
                   draws: dict | None = None,
                   return_images: bool = False, mesh=None) -> dict:
    """One VDM step, in place on `state`; returns the metrics (losses,
    the pre-clip `grad_norm`, `skipped`, the rollout's draws) and, with
    `return_images` on a reward step, "images": (the decoded frame (1, H,
    W, 3), the rendered views (V, H, W, 3)) in [0, 1], detached — the
    every-10-step grid of `cli/train_vdm.py::run`.

    video (B, 3, T, H, W) in [−1, 1]; sft_text (B, L, text_dim);
    rl_cond / rl_uncond (1, L, text_dim) rollout prompts; reward_loss_fn
    from `train.reward.make_loss_fn` (None: SFT only); reward_text
    (pick_text, pe_text) per-prompt scorer features.  `draws` overrides
    the step's draws: num_steps, backprop_idx, guidance (`draw_step`'s
    keys), posterior_eps, flow_eps, flow_sigma, latents0, perm, frame.
    `mesh`: the `core/mesh.py` mesh the batch and the DiT lie on (see the
    module docstring)."""
    step = state.step
    device = video.device
    rl = cfg.enable_rl and reward_loss_fn is not None
    d = {**draw_step(seed, step, cfg, rl), **(draws or {})}
    gens = {p: _generator(seed, step, p, device)
            for p in (_VAE, _FLOW, _NOISE, _REWARD)}
    lcfg = cfg.lora
    dt = dit.patch_embedding.weight.dtype
    params = list(flat_lora(state.lora).values())
    for p in params:
        p.grad = None

    # the frozen VAE encode of the SFT clip in bf16 activations (the
    # reference encodes inside its autocast-bf16 step), a posterior sample
    with torch.no_grad():
        mu, logvar = wan_vae.encode(vae_encoder, video.to(torch.bfloat16))
        mu, logvar = mu.float(), logvar.float()
        eps = d.get("posterior_eps")
        eps = mesh_mod.randn_rows(mu.shape, gens[_VAE], mesh, device=device,
                                  dtype=mu.dtype) if eps is None \
            else eps.to(device)
        z0 = wan_vae.normalize_latents(
            wan_vae.sample_posterior(mu, logvar, None, eps=eps))
    # ε, then σ, from one generator, as `make_flow_batch` draws them
    flow_eps, flow_sigma = d.get("flow_eps"), d.get("flow_sigma")
    if flow_eps is None:
        flow_eps = mesh_mod.randn_rows(z0.shape, gens[_FLOW], mesh,
                                       device=device)
    if flow_sigma is None:
        flow_sigma = mesh_mod.rand_rows(z0.shape[:1], gens[_FLOW], mesh,
                                        device=device)
    z_sigma, ts, target = flow_match.make_flow_batch(
        z0, eps=flow_eps, sigma=flow_sigma)
    pred = wan_dit.forward(dit, z_sigma.to(dt), ts, sft_text.to(dt),
                           remat=True, lora=state.lora,
                           lora_cfg=lcfg).float()
    diffusion_loss = flow_match.flow_matching_loss(pred, target)
    diffusion_loss.backward()
    del pred, target, z_sigma

    reward_loss = torch.zeros((), device=device)
    images = None
    if rl:
        latents0 = d.get("latents0")
        if latents0 is None:
            latents0 = torch.randn(latent_shape, generator=gens[_NOISE],
                                   device=device)
        lat = rollout(dit, latents0.to(device), rl_cond, rl_uncond,
                      num_steps=d["num_steps"], guidance_scale=d["guidance"],
                      backprop_idx=d["backprop_idx"],
                      flow_shift=cfg.flow_shift, lora=state.lora,
                      lora_cfg=lcfg)
        lat_un = wan_vae.unnormalize_latents(lat)
        # the reward decode in bf16 activations over fp32 weights (the
        # reference's reward branch runs under autocast bf16)
        decoded = wan_vae.decode(vae_decoder, lat_un.to(torch.bfloat16),
                                 remat=True).float()
        reward_loss, images = calculate_reward(
            lat_un, decoded, stitched, scfg, reward_loss_fn,
            generator=gens[_REWARD], perm=d.get("perm"),
            frame=d.get("frame"), render_size=render_size,
            pair_budget=pair_budget, text_feats=reward_text)
        reward_loss.backward()

    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    mesh_mod.reduce_lora_grads(grads, mesh,
                               tensor_parallel=dit.tp is not None)
    gnorm = global_norm(grads)
    finite = bool(torch.isfinite(gnorm))
    if finite:
        # optax clip_by_global_norm: g unchanged below the limit, else
        # g/‖g‖·c
        if gnorm >= cfg.grad_clip:
            torch._foreach_div_(grads, gnorm)
            torch._foreach_mul_(grads, cfg.grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
    # a non-finite norm skips the update (`train_vdm.py:641-644`); the EMA
    # steps either way, toward the unchanged factors
    ema_mod.update_ema(state.ema, flat_lora(state.lora), step,
                       ema_mod.EMAConfig(decay=cfg.ema_decay))
    state.step += 1
    losses = mesh_mod.mean_over_data(
        {"diffusion_loss": diffusion_loss.detach(),
         "reward_loss": reward_loss.detach()}, mesh)
    total = losses["diffusion_loss"] + losses["reward_loss"]
    return {**losses, "total_loss": total,
            "grad_norm": gnorm.detach(), "skipped": not finite,
            "num_steps": d["num_steps"],
            "backprop_idx": [int(i) for i in d["backprop_idx"]],
            "guidance": float(d["guidance"]),
            **({"images": images} if return_images and images else {})}


# --------------------------------------------------------------------------- #
# camera-motion prompt augmentation (`train_vdm.py:140-245`)                  #
# --------------------------------------------------------------------------- #
def camera_prompt_templates(prompt: str) -> list[str]:
    base = f"`{prompt}`"
    return [
        base,  # the reference's first entry is the literal string "base" —
               # almost surely meant the plain prompt; we use the prompt
        # 1. pan
        f"The camera pans smoothly from left to right across the scene: {base}. The horizontal motion reveals new spatial elements with each frame.",
        f"The camera performs a fast horizontal sweep, scanning the environment around the main subject: {base}.",
        f"A gentle left-to-right camera pan introduces the scene: {base}. The motion builds anticipation as more details appear.",
        f"The camera quickly pans from right to left, revealing the opposite side of the scene: {base}.",
        f"Pan the camera horizontally to uncover the subject and background in a fluid movement: {base}.",
        f"The camera moves in a slow panoramic motion across the horizon: {base}. This reveals a wide, cinematic field of view.",
        f"The camera performs a smooth 360° panoramic rotation around the scene: {base}. The motion fully encircles the environment.",
        # 2. orbit
        f"The camera orbits around the main subject: {base}. This motion provides multiple perspectives of the central focus.",
        f"A circular orbit movement reveals all sides of the object in: {base}. The subject remains centered while the environment shifts naturally.",
        f"The camera rotates around the scene, maintaining constant distance: {base}. The orbiting trajectory captures 3D structure and consistency.",
        f"The camera performs a full circular path, orbiting around the main focus: {base}.",
        f"The camera glides around the subject in a semicircular arc, showing it from both front and side views: {base}.",
        # 3. dolly
        f"The camera dollies inward toward the subject: {base}. The forward motion increases immersion and depth.",
        f"A slow dolly-out reveals the full environment behind the subject: {base}.",
        f"The camera pushes forward into the center of the scene: {base}. This close approach emphasizes detail and perspective.",
        f"The camera pulls backward from the subject, gradually exposing the surrounding world: {base}.",
        f"A dolly-in transition draws attention to the main object in: {base}. The camera motion builds intensity and focus.",
        # 4. zoom
        f"The camera zooms in slowly to magnify the central details of: {base}.",
        f"The camera performs a fast zoom-out to show the full 3D layout of: {base}.",
        f"A gentle zoom-in enhances focus on the core region of: {base}.",
        f"Zoom the camera lens steadily to emphasize the subject in: {base}.",
        f"The camera zooms out gradually from a close-up view, unveiling the complete composition: {base}.",
        # 5. tilt
        f"The camera tilts upward from the base to the sky: {base}. The vertical movement highlights height and scale.",
        f"The camera tilts downward toward the ground: {base}. This viewpoint emphasizes spatial grounding.",
        f"A smooth upward tilt reveals tall architectural structures in: {base}.",
        f"The camera performs a vertical sweep from top to bottom: {base}. The tilt motion enriches the perception of depth.",
        f"The camera tilts slightly while maintaining focus on the subject: {base}.",
        # 6. fly-through
        f"The camera flies smoothly through the 3D environment: {base}. The flight motion provides a sense of exploration.",
        f"The camera glides like a drone over the terrain: {base}. The aerial trajectory emphasizes continuity and scale.",
        f"The camera flies low across the scene: {base}. The close pass accentuates ground details and parallax.",
        f"The camera navigates through narrow spaces in: {base}. It moves dynamically, avoiding obstacles.",
        f"A cinematic fly-through motion traverses the environment: {base}. The continuous travel conveys immersion.",
        # 7. arc
        f"The camera moves along a curved arc around the subject: {base}. The motion reveals both profile and depth.",
        f"A smooth arc path captures the subject from multiple diagonal angles: {base}.",
        f"The camera glides through an arc trajectory at mid-height: {base}.",
        f"The arc-shaped movement maintains focus on the central point while changing background parallax: {base}.",
        f"The camera performs a half-orbit arc, revealing the subject's side and back view: {base}.",
        # 8. spiral
        f"The camera spirals upward around the object: {base}. The motion combines rotation and elevation.",
        f"The camera follows a helical path circling the subject: {base}.",
        f"A downward spiral descends smoothly toward the scene center: {base}.",
        f"The camera performs a spiral ascent around the 3D environment: {base}.",
        f"A slow, tightening spiral focuses attention on the subject at the core: {base}.",
        # 9. tracking
        f"The camera tracks a moving subject through the space: {base}. The perspective stays consistent during motion.",
        f"A tracking shot keeps the subject centered as it moves dynamically through: {base}.",
        f"The camera follows the target's trajectory with cinematic smoothness: {base}.",
        f"A continuous tracking motion moves alongside the subject: {base}.",
        f"The camera mirrors the subject's motion path, maintaining constant distance: {base}.",
        # 10. crane
        f"The camera rises vertically like a crane shot: {base}. The elevation change provides an aerial overview.",
        f"A slow crane movement lowers the camera toward the scene: {base}.",
        f"The camera lifts steadily upward from ground level: {base}. The ascending motion reveals overall spatial layout.",
        f"A crane motion elevates the viewpoint to a higher perspective: {base}.",
        f"The camera descends smoothly back down to focus on details: {base}.",
        # 11. rotation-in-place
        f"The camera rotates 360° around its axis at a fixed point: {base}.",
        f"A stationary spin reveals every direction of the surrounding scene: {base}.",
        f"The camera performs a slow turn-in-place while keeping balance: {base}.",
        f"A gentle rotational sweep captures panoramic surroundings of: {base}.",
        f"The camera spins steadily to record all angles of the subject: {base}.",
        # 12. handheld
        f"The camera captures {base} with a subtle handheld feel, adding realism and intimacy.",
        f"A natural, slightly shaky handheld motion records: {base}.",
        f"The handheld camera follows the subject closely, simulating human perspective: {base}.",
        f"The shot feels organic, as if captured by a person exploring: {base}.",
        f"The handheld style gives {base} a dynamic and lifelike tone.",
        # 13. composite
        f"The camera starts with a dolly-in and transitions to a circular orbit: {base}.",
        f"A horizontal pan merges into a tilt-up movement: {base}.",
        f"The motion begins as a zoom-in, then arcs around the object: {base}.",
        f"The camera begins with a fly-through and ends with a spiral ascent: {base}.",
        f"A dolly-out ends with a 360° in-place rotation: {base}.",
        # 14. temporal
        f"The camera slowly accelerates over time while capturing: {base}.",
        f"A rapid start transitions into a steady glide through the scene: {base}.",
        f"The motion starts slowly, then speeds up near the subject: {base}.",
        f"The camera eases in at the start, then gently slows as it completes the movement: {base}.",
        f"The motion evolves gradually during the sequence: {base}.",
        # 15. cinematic tone
        f"The camera glides gracefully with cinematic smoothness across: {base}.",
        f"A dramatic sweeping camera move emphasizes the grandeur of: {base}.",
        f"The slow, contemplative camera motion captures the serene atmosphere of: {base}.",
        f"A dynamic, energetic camera movement enhances the intensity of: {base}.",
        f"A suspenseful tracking motion builds tension throughout: {base}.",
        # 16. experimental
        f"The camera rolls diagonally while approaching the scene: {base}.",
        f"The camera oscillates subtly, mimicking breathing motion: {base}.",
        f"A free-floating camera drifts unpredictably through: {base}.",
        f"The shot involves alternating zoom and pan motions to emphasize rhythm: {base}.",
        f"The camera performs a parallax sweep that dynamically layers depth: {base}.",
    ]


def augment_camera_prompt(rng: np.random.Generator, prompt: str) -> str:
    """A uniform choice over the templates (`train_vdm.py:245`)."""
    templates = camera_prompt_templates(prompt)
    return templates[int(rng.integers(0, len(templates)))]
