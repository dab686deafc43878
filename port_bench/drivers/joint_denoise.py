"""Driver `joint_denoise`: CogVideoX text→latent requests back to back, one
client in a closed loop, at B = 1 with the CFG pair batched to 2.

Each request runs `pipelines/t23d.py::embed_prompts` (T5 v1.1, no mask,
the negative prompt "") and `denoise` with the configuration's
`T2VConfig`: 50 v-prediction DDIM steps over the CogVideoX DiT, whose
joint attention covers 226 text and 17,550 video tokens.  A step costs
over a second, so the window (51 s) ends inside the first request: a
forward pre-hook on the DiT ends it at the first step boundary past
`run.seconds` (the step in flight completes and counts, the request it
belongs to stops there).  `denoise_step_ms` is the window's wall time
over the CFG steps completed in it.  Set-up warms a request of
`WARM_STEPS` steps.  With --trace 1 the profiler covers the window's
first `TRACED_STEPS` steps.

The check follows the window's first request over the steps it completed
(fewer than `MIN_STEPS` fail the run): the DiT's inputs and outputs at
every step, copied to the host as they are made (`Recorder`), and the
latents after the last completed step, which the cut step's pre-hook
sees as the sampler holds them (fp32: the DiT casts them itself).  It
compares the prompt embeddings against the reference's from the token
ids (`embed_rel`); the DiT's v at `CHECKED_STEPS` completed steps drawn
from the seed, against the reference DiT in float32 on the same inputs
(`velocity_rel`); the latents after the last completed step against the
reference's DDIM chain from the same noise over the program's DiT
outputs (`chain_rel`); and, at every completed step, what the program
gave its DiT (latents, timesteps, the text pair [uncond, cond]) against
what that chain gives (`inputs_rel`).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from port_bench import common, t23d_parts as parts
from port_bench import trace as trace_mod
from port_bench.drivers.denoise import Recorder, input_gap

TRACED_STEPS = 5
CHECKED_STEPS = 3
MIN_STEPS = 20
WARM_STEPS = 2
WARM_INDEX = 1_000_000
# the control's and the program's steps in `sweep_seed`: about what a
# window completes of its first request
SWEEP_STEPS = 25
PARTS = ("t5", "dit")


class _WindowClosed(Exception):
    """Raised by the DiT's pre-hook at the first step past the window (or
    past a sweep's steps)."""


def program_config(run):
    from vist3a_tpu_torch.pipelines import t23d

    return common.from_dict(t23d.T2VConfig(), run.config["t2v"])


def build_program(run, cfg) -> dict:
    """T5 and the DiT as deployed, in bf16, every parameter from the seed
    (`common.fill_weights`, T5 first)."""
    from vist3a_tpu_torch.nn import cogvideox_dit, umt5

    makers = {"t5": lambda: umt5.UMT5Encoder(cfg.t5),
              "dit": lambda: cogvideox_dit.CogVideoXDiT(cfg.dit)}
    mods = {}
    for name in PARTS:
        with torch.device("meta"):
            m = makers[name]()
        m = m.to(torch.bfloat16).to_empty(device=run.device)
        mods[name] = m.eval().requires_grad_(False)
    common.fill_weights(mods, run.seed, run.config["weights"]["overrides"],
                        run.device)
    return mods


def required_steps(cfg) -> int:
    return min(MIN_STEPS, cfg.num_inference_steps)


def setup(run) -> None:
    from vist3a_tpu_torch.pipelines import t23d

    cfg = program_config(run)
    run.state["cfg"] = cfg
    run.state["tokenize"] = tok = common.tokenizer(
        cfg.t5.max_sequence_length, cfg.t5.vocab_size)
    t0 = time.perf_counter()
    run.state["mods"] = mods = build_program(run, cfg)
    common.sync(run.device)
    t1 = time.perf_counter()
    # every shape of the traffic: the prompt pair and WARM_STEPS CFG steps
    prompt, z = parts.request_inputs(run, cfg, WARM_INDEX)
    cond, uncond = t23d.embed_prompts(mods["t5"], tok, prompt,
                                      device=run.device, cfg=cfg)
    warm = Recorder(1)
    hooks = warm.hooks(mods["dit"], lambda: 0)
    t23d.denoise(mods["dit"], cond, uncond,
                 dataclasses.replace(cfg, num_inference_steps=WARM_STEPS),
                 latents0=z, device=run.device)
    for h in hooks:
        h.remove()
    run.state["recorder"] = Recorder(
        cfg.num_inference_steps, warm.steps[0],
        pin=torch.device(run.device).type == "cuda")
    parts.log_setup(run, t0, t1)


def checked_steps(run, n_steps: int) -> list[int]:
    return sorted(int(s) for s in common.rng(run.seed, 5).choice(
        n_steps, size=min(CHECKED_STEPS, n_steps), replace=False))


def window(run) -> None:
    from vist3a_tpu_torch.pipelines import t23d

    cfg, mods = run.state["cfg"], run.state["mods"]
    dit = mods["dit"]
    rec = run.state.pop("recorder")
    st = {"steps": 0, "request": 0, "step_in_request": 0}
    tracer = trace_mod.Tracer() if run.trace else None
    t0 = time.perf_counter()

    def pre(module, args):
        if st["steps"] and time.perf_counter() - t0 >= run.seconds:
            if st["request"] == 0:
                # the latents after the last completed step, as the
                # sampler holds them (the first of the CFG pair)
                run.state["kept"]["latents"] = args[0][:1].to(
                    "cpu", torch.float32, copy=True)
            raise _WindowClosed

    def post(module, args, out):
        st["steps"] += 1
        st["step_in_request"] += 1
        if tracer is not None and st["steps"] == TRACED_STEPS:
            stop_trace()

    def stop_trace():
        run.trace_data = tracer.stop()
        after = parts.launch_counts()
        run.counters["traced_launches"] = {k: after[k] - before[k]
                                           for k in after}
        run.counters["traced_steps"] = st["steps"]
        st["t_untraced"] = time.perf_counter()

    def recording():
        return st["step_in_request"] if st["request"] == 0 else None

    # the window's own hook first: a step past the window records nothing
    hooks = [dit.register_forward_pre_hook(pre)] \
        + rec.hooks(dit, recording) + [dit.register_forward_hook(post)]
    if tracer is not None:
        before = parts.launch_counts()
        tracer.start()
    try:
        while True:
            prompt, z = parts.request_inputs(run, cfg, st["request"])
            st["step_in_request"] = 0
            run.attempted += 1
            try:
                cond, uncond = t23d.embed_prompts(
                    mods["t5"], run.state["tokenize"], prompt,
                    device=run.device, cfg=cfg)
                if st["request"] == 0:
                    run.state["kept"] = {"cond": cond, "uncond": uncond}
                lat = t23d.denoise(dit, cond, uncond, cfg, latents0=z,
                                   device=run.device)
            except _WindowClosed:
                break
            if st["request"] == 0:
                run.state["kept"]["latents"] = lat
            st["request"] += 1
        common.sync(run.device)
        t_end = time.perf_counter()
    finally:
        for h in hooks:
            h.remove()
    if tracer is not None and run.trace_data is None:
        stop_trace()
    run.e2e["denoise_step_ms"] = 1e3 * (t_end - t0) / st["steps"]
    run.counters["steps"] = st["steps"]
    if "t_untraced" in st and st["steps"] > TRACED_STEPS:
        # the steps after the profiler stopped, for `mfu.joint-denoise`
        run.counters["untraced_steps"] = st["steps"] - TRACED_STEPS
        run.counters["untraced_s"] = t_end - st["t_untraced"]
    run.state["steps"] = rec.finished()
    if len(run.state["steps"]) < required_steps(cfg) \
            or "latents" not in run.state.get("kept", {}):
        run.failed += 1     # the first request completed too few steps


def free(run) -> None:
    run.state.pop("mods", None)
    common.empty_cache(run.device)


def _reference_configs(run):
    from port_bench.reference import cogvideox as ref

    t2v = run.config["t2v"]
    return ref.T5Config(**t2v["t5"]), ref.CogVideoXConfig(**t2v["dit"])


def build_reference(name: str, cfg, stream: common.WeightStream, device,
                    dtype=torch.float32):
    """The reference's module `name` ("t5", "dit") in `dtype`, its weights
    the next ones of the seed's `stream`: build them in the program's
    order."""
    from port_bench.reference import cogvideox as ref

    maker = ref.T5Encoder if name == "t5" else ref.CogVideoXDiT
    with torch.device("meta"):
        m = maker(cfg)
    m = m.to(dtype).to_empty(device=device).eval().requires_grad_(False)
    stream.fill(name, m)
    return m


def reference_numbers(run, got: dict) -> dict:
    """The float32 reference of the kept request from the benchmark's
    inputs and the program's own state (see the module's docstring).
    got["steps"] holds the DiT's (x, timesteps, text, output) at each
    completed step, got["latents"] the latents after the last of them."""
    from port_bench.reference import cogvideox as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = run.device
    cfg = run.state["cfg"]
    t5_cfg, dit_cfg = _reference_configs(run)
    stream = common.WeightStream(run.seed, dev,
                                 run.config["weights"]["overrides"])
    prompt, z = parts.request_inputs(run, cfg, 0)
    t5 = build_reference("t5", t5_cfg, stream, dev)
    cond, uncond = ref.embed(t5, run.state["tokenize"], prompt, dev)
    del t5
    common.empty_cache(dev)
    steps = got["steps"]
    dit = build_reference("dit", dit_cfg, stream, dev)
    vel = []
    for k in checked_steps(run, len(steps)):
        x, ts, text, out = (t.to(dev) for t in steps[k])
        want = ref.dit_forward(dit, x.float(), ts.float(), text.float())
        vel.append(common.rel(out.float(), want))
    del dit
    common.empty_cache(dev)
    gaps = []
    recorded = iter(steps)

    def dit_apply(x2, ts, text):
        x_p, ts_p, text_p, out = next(recorded)
        gaps.extend(input_gap(p, r) for p, r in
                    ((x_p, x2), (ts_p, ts), (text_p, text)))
        return out.to(dev).float()

    if all(tuple(s[0].shape) == (2, *z.shape[1:]) and s[3].shape == s[0].shape
           for s in steps):
        model_fn = ref.cfg_model(dit_apply, got["cond"].to(dev).float(),
                                 got["uncond"].to(dev).float(),
                                 cfg.guidance_scale)
        chain = ref.sample(model_fn, z.float(), ref.SchedulerConfig(),
                           cfg.num_inference_steps, steps=len(steps))
        chain_rel = common.rel(got["latents"].to(dev).float(), chain)
        inputs_rel = max(gaps)
    else:
        # not the CFG pair the sampler needs
        chain_rel = inputs_rel = float("inf")
    return {
        "embed_rel": common.rel(torch.cat([got["cond"], got["uncond"]]),
                                torch.cat([cond, uncond])),
        "velocity_rel": max(vel),
        "chain_rel": chain_rel,
        "inputs_rel": inputs_rel,
    }


def check(run) -> list:
    kept = run.state.get("kept") or {}
    limits = run.cell["limits"]
    steps = run.state.pop("steps", [])
    if "latents" not in kept or len(steps) < required_steps(
            run.state["cfg"]):
        return [(n, float("inf"), limits[n]) for n in limits]
    numbers = reference_numbers(run, {**kept, "steps": steps})
    return [(n, numbers[n], limits[n]) for n in limits]


def control_request(run, n_steps: int) -> dict:
    """The control in the program's place: T5 and the DiT of the reference
    in bf16 over weights rounded to float8 e4m3, the DDIM state in bf16
    (one step below the fp32 the sampler states), over the first `n_steps`
    steps of request 0; its DiT's inputs and outputs recorded as the
    program's are."""
    from port_bench.reference import cogvideox as ref
    from port_bench.reference.scene import fp8_round_weights

    cfg = run.state["cfg"]
    t5_cfg, dit_cfg = _reference_configs(run)
    stream = common.WeightStream(run.seed, run.device,
                                 run.config["weights"]["overrides"])
    prompt, z = parts.request_inputs(run, cfg, 0)
    bf16 = torch.bfloat16
    t5 = build_reference("t5", t5_cfg, stream, run.device, bf16)
    fp8_round_weights({"t5": t5})
    cond, uncond = ref.embed(t5, run.state["tokenize"], prompt, run.device)
    del t5
    dit = build_reference("dit", dit_cfg, stream, run.device, bf16)
    fp8_round_weights({"dit": dit})
    steps = []

    def dit_apply(x2, ts, text):
        out = ref.dit_forward(dit, x2, ts, text)
        steps.append((x2, ts, text, out))
        return out

    model_fn = ref.cfg_model(dit_apply, cond, uncond, cfg.guidance_scale)
    lat = ref.sample(model_fn, z.to(bf16), ref.SchedulerConfig(),
                     cfg.num_inference_steps, steps=n_steps)
    del dit
    common.empty_cache(run.device)
    return {"cond": cond, "uncond": uncond, "latents": lat.float(),
            "steps": steps}


def program_request(run, n_steps: int) -> dict:
    """Request 0 through the program, untimed, cut after `n_steps` steps as
    a window cuts it (all of them where `n_steps` is the request's)."""
    from vist3a_tpu_torch.pipelines import t23d

    cfg = run.state["cfg"]
    mods = build_program(run, cfg)
    dit = mods["dit"]
    rec = Recorder(cfg.num_inference_steps)
    step, kept = [0], {}

    def stop(module, args):
        if step[0] == n_steps:
            kept["latents"] = args[0][:1].float().clone()
            raise _WindowClosed

    def count(module, args, out):
        step[0] += 1
    hooks = [dit.register_forward_pre_hook(stop)] \
        + rec.hooks(dit, lambda: step[0]) + [dit.register_forward_hook(count)]
    prompt, z = parts.request_inputs(run, cfg, 0)
    cond, uncond = t23d.embed_prompts(mods["t5"], run.state["tokenize"],
                                      prompt, device=run.device, cfg=cfg)
    try:
        kept["latents"] = t23d.denoise(dit, cond, uncond, cfg, latents0=z,
                                       device=run.device)
    except _WindowClosed:
        pass
    for h in hooks:
        h.remove()
    del mods, dit
    common.empty_cache(run.device)
    return {"cond": cond, "uncond": uncond, "latents": kept["latents"],
            "steps": rec.finished()}


def sweep_seed(run, program: bool, control: bool) -> dict:
    """`sweep.py`'s readings for one seed: request 0 untimed through the
    program, and through the control, each cut after `SWEEP_STEPS` steps
    and judged as a run's check does."""
    cfg = program_config(run)
    run.state["cfg"] = cfg
    run.state["tokenize"] = common.tokenizer(cfg.t5.max_sequence_length,
                                             cfg.t5.vocab_size)
    n_steps = min(SWEEP_STEPS, cfg.num_inference_steps)
    numbers = {}
    if program:
        numbers["program"] = reference_numbers(run,
                                               program_request(run, n_steps))
    if control:
        numbers["control"] = reference_numbers(run,
                                               control_request(run, n_steps))
    return numbers
