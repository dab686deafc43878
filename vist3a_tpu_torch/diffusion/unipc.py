"""UniPC multistep sampler with flow sigmas (Wan's scheduler).

Port of `vist3a_tpu/diffusion/unipc.py`: diffusers
`UniPCMultistepScheduler(prediction_type="flow_prediction",
use_flow_sigmas=True, flow_shift=s)`, solver order 2, B(h) = e^h − 1
("bh2"), x₀ prediction, lower order at the final step.

  * σ grid: linspace(1, 1/1000, N+1) warped by σ ← s·σ / (1 + (s−1)·σ),
    descending, a terminal σ = 0; timesteps σ·1000;
  * flow parameterisation: α = 1 − σ, the model predicts v = ε − x₀, so
    x₀ = x − σ·v.

The schedule math runs on the host in float64; the coefficients reach the
latents as fp32 scalars.  `sample_scan` runs the chain from
`precompute_coeffs` — one affine update per step with every coefficient
precomputed — as a Python loop over fp32 coefficient tensors on the
latents' device, where the JAX package runs one `lax.scan`.  The JAX
package's step-by-step `sample` (with `unipc_p_update` / `unipc_c_update`)
computes the same chain; here it would be a second Python loop with no
caller, so the port has only `sample_scan`, and its tests hold it against
both JAX forms.  The training rollout's record-and-replay forms are
`sample_scan_record` (the no-grad rollout, recording each step's model
input and output) and `replay_affine` (the same affine chain over given
model outputs, differentiable in them); both run the arithmetic of
`sample_scan`, so the replay's value is the recorded rollout's.  Each step
of `sample_scan` and `sample_scan_record` is a span `unipc.step`
(`core/profiling.span`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from vist3a_tpu_torch.core.profiling import span


def flow_sigmas(num_steps: int, shift: float = 3.0,
                num_train_timesteps: int = 1000
                ) -> tuple[np.ndarray, np.ndarray]:
    """(σ float64 with a trailing 0, timesteps σ·1000 float32)."""
    alphas = np.linspace(1.0, 1.0 / num_train_timesteps, num_steps + 1)
    s = 1.0 - alphas
    s = shift * s / (1.0 + (shift - 1.0) * s)
    s = np.flip(s)[:-1]                       # descending, drop the 0
    timesteps = s * num_train_timesteps
    sigmas = np.concatenate([s, [0.0]]).astype(np.float64)
    return sigmas, timesteps.astype(np.float32)


def _alpha_sigma(sig: float) -> tuple[float, float]:
    return 1.0 - sig, sig


def _lambda(sig: float) -> float:
    a, s = _alpha_sigma(sig)
    # guard the terminal σ = 0 (never used as a source)
    return math.log(max(a, 1e-12)) - math.log(max(s, 1e-12))


@dataclasses.dataclass(frozen=True)
class UniPCConfig:
    num_steps: int = 50
    shift: float = 3.0
    solver_order: int = 2
    num_train_timesteps: int = 1000


def _uni_bh_coeffs(h: float, rks: Sequence[float], order: int):
    """R matrix, b vector, h·φ₁ and B(h) of UniPC-bh2 (host, float64)."""
    hh = -h                      # x₀-prediction branch
    h_phi_1 = math.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1.0
    b_h = math.expm1(hh)         # bh2
    R, b = [], []
    factorial_i = 1.0
    rks = np.asarray(list(rks), np.float64)
    for i in range(1, order + 1):
        R.append(rks ** (i - 1))
        b.append(h_phi_k * factorial_i / b_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return np.stack(R), np.asarray(b), h_phi_1, b_h


def order_schedule(num_steps: int, solver_order: int) -> list[int]:
    """The solver order of each step (lower order at the end, warm-up by
    history at the start)."""
    return [min(solver_order, num_steps - i, i + 1) for i in range(num_steps)]


def cfg_model(dit_apply: Callable, cond: torch.Tensor, uncond: torch.Tensor,
              guidance_scale: float) -> Callable:
    """Classifier-free guidance with the pair batched into one forward:
    dit_apply(x2, ts, text) on [x, x] with text [uncond, cond]."""
    text = torch.cat([uncond, cond], dim=0)

    def model_fn(x, t):
        x2 = torch.cat([x, x], dim=0)
        ts = torch.as_tensor(t, dtype=torch.float32,
                             device=x.device).expand(x2.shape[0])
        v_u, v_c = dit_apply(x2, ts, text).chunk(2, dim=0)
        return v_u + guidance_scale * (v_c - v_u)
    return model_fn


COEFFS = ("timesteps", "sigmas", "P_cx", "P_cm0", "P_cd1", "C_cx", "C_cm0",
          "C_hist", "C_new")


def precompute_coeffs(cfg: UniPCConfig) -> dict[str, np.ndarray]:
    """Every per-step scalar of the chain (host float64, returned as
    float32 arrays of length num_steps).  With the history coefficients
    zeroed, the order-2 update is exactly the order-1 update, so one body
    serves the whole schedule:

      predictor: x_{i+1} = P_cx·x − P_cm0·m_i − P_cd1·(m_{i−1} − m_i)
      corrector: x_i ← C_cx·x_{i−1}ˢ − C_cm0·m_{i−1}
                        − C_hist·(m_{i−2} − m_{i−1}) − C_new·(mᵗ − m_{i−1})
    """
    sigmas, timesteps = flow_sigmas(cfg.num_steps, cfg.shift,
                                    cfg.num_train_timesteps)
    orders = order_schedule(cfg.num_steps, cfg.solver_order)
    n = cfg.num_steps
    c = {k: np.zeros(n) for k in COEFFS[2:]}

    for i in range(n):
        sig_t, sig_s0 = float(sigmas[i + 1]), float(sigmas[i])
        a_t, s_t = _alpha_sigma(sig_t)
        _, s_s0 = _alpha_sigma(sig_s0)
        lam_t, lam_s0 = _lambda(sig_t), _lambda(sig_s0)
        h = lam_t - lam_s0
        b_h = math.expm1(-h)          # = h·φ₁ as well (bh2)
        c["P_cx"][i] = s_t / s_s0
        c["P_cm0"][i] = a_t * b_h
        if orders[i] >= 2:
            rk = (_lambda(float(sigmas[i - 1])) - lam_s0) / h
            c["P_cd1"][i] = a_t * b_h * 0.5 / rk

        if i == 0:
            c["C_cx"][i] = 1.0        # identity corrector at the first step
            continue
        sig_ct, sig_cs0 = float(sigmas[i]), float(sigmas[i - 1])
        a_ct, s_ct = _alpha_sigma(sig_ct)
        _, s_cs0 = _alpha_sigma(sig_cs0)
        lam_cs0 = _lambda(sig_cs0)
        hc = _lambda(sig_ct) - lam_cs0
        b_hc = math.expm1(-hc)
        c["C_cx"][i] = s_ct / s_cs0
        c["C_cm0"][i] = a_ct * b_hc
        if orders[i - 1] == 1:
            c["C_new"][i] = a_ct * b_hc * 0.5
        else:
            rk_c = (_lambda(float(sigmas[i - 2])) - lam_cs0) / hc
            _, b_vec, _, _ = _uni_bh_coeffs(hc, [rk_c, 1.0], 2)
            rhos = np.linalg.solve(np.stack([np.ones(2),
                                             np.asarray([rk_c, 1.0])]),
                                   b_vec)
            c["C_hist"][i] = a_ct * b_hc * rhos[0] / rk_c
            c["C_new"][i] = a_ct * b_hc * rhos[1]

    return {"timesteps": timesteps.astype(np.float32),
            "sigmas": sigmas[:-1].astype(np.float32),
            **{k: v.astype(np.float32) for k, v in c.items()}}


def _device_coeffs(cfg: UniPCConfig, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device)
            for k, v in precompute_coeffs(cfg).items()}


def _step(per: dict, v: torch.Tensor, x, last, m1, m2):
    """One affine update of the chain → (x_next, x_c, m_this)."""
    m_this = x - per["sigmas"] * v
    x_c = (per["C_cx"] * last - per["C_cm0"] * m1
           - per["C_hist"] * (m2 - m1) - per["C_new"] * (m_this - m1))
    x_next = (per["P_cx"] * x_c - per["P_cm0"] * m_this
              - per["P_cd1"] * (m1 - m_this))
    return x_next, x_c, m_this


def sample_scan(model_fn: Callable, latents: torch.Tensor,
                cfg: UniPCConfig = UniPCConfig()) -> torch.Tensor:
    """The denoise loop from the precomputed coefficients.  model_fn(x, t)
    → flow prediction (CFG folded in by the caller), t a 0-d fp32 tensor;
    returns the final latent.  The update of every step is the same affine
    body, its fp32 coefficients one tensor per name on the latents' device
    (copied there once, read without a host sync)."""
    coeffs = _device_coeffs(cfg, latents.device)
    x, last = latents, latents
    m1 = m2 = torch.zeros_like(latents)
    for i in range(cfg.num_steps):
        with span("unipc.step"):
            per = {k: v[i] for k, v in coeffs.items()}
            v = model_fn(x, per["timesteps"])
            x_next, last, m_this = _step(per, v, x, last, m1, m2)
            x, m1, m2 = x_next, m_this, m1
    return x


@torch.no_grad()
def sample_scan_record(model_fn: Callable, latents: torch.Tensor,
                       cfg: UniPCConfig = UniPCConfig()):
    """`sample_scan` without grad, recording every step's model input and
    output → (x_final, x_stack, v_stack), the stacks (num_steps,
    *latents.shape)."""
    coeffs = _device_coeffs(cfg, latents.device)
    x, last = latents, latents
    m1 = m2 = torch.zeros_like(latents)
    xs, vs = [], []
    for i in range(cfg.num_steps):
        with span("unipc.step"):
            per = {k: v[i] for k, v in coeffs.items()}
            v = model_fn(x, per["timesteps"])
            xs.append(x)
            vs.append(v)
            x_next, last, m_this = _step(per, v, x, last, m1, m2)
            x, m1, m2 = x_next, m_this, m1
    return x, torch.stack(xs), torch.stack(vs)


def replay_affine(v_stack: torch.Tensor, latents: torch.Tensor,
                  cfg: UniPCConfig = UniPCConfig()) -> torch.Tensor:
    """The chain of `sample_scan` with the model outputs given (v_stack
    (num_steps, *latents.shape), some rows differentiable): the same
    arithmetic, so the value is the recorded rollout's, and the gradient
    flows through v_stack and the affine chain."""
    coeffs = _device_coeffs(cfg, latents.device)
    x, last = latents, latents
    m1 = m2 = torch.zeros_like(latents)
    for i in range(cfg.num_steps):
        per = {k: v[i] for k, v in coeffs.items()}
        x_next, last, m_this = _step(per, v_stack[i], x, last, m1, m2)
        x, m1, m2 = x_next, m_this, m1
    return x
