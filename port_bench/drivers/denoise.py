"""Driver `denoise`: text→latent requests back to back, one client in a
closed loop, at B = 1 with the CFG pair batched to 2.

Each request runs `pipelines/t23d.py::embed_prompts` and then `denoise`,
its 50 UniPC steps over the DiT.  A forward pre-hook on the DiT ends the
window at the first step boundary past `run.seconds`: the step in flight
completes and counts, the request it belongs to stops there.
`denoise_step_ms` is the window's wall time over the CFG steps completed
in it.  With --trace 1 the profiler covers the window's first
`TRACED_STEPS` steps, and every step closes with a synchronize.

The check follows the program's own state on the first request, which
the window completes: the DiT's inputs and outputs at every step, copied
to the host as they are made (`Recorder`).  It compares the prompt
embeddings against the reference's from the token ids; the DiT's
velocity at `CHECKED_STEPS` steps drawn from the seed, against the
reference DiT in float32 on the same inputs; the request's final latents
against the reference's UniPC chain run from the same noise and the
program's embeddings over the velocities the program's DiT gave; and, at
every step of that chain, what the program gave its DiT (the latents, the
timesteps, the text pair [uncond, cond]) against what the chain gives.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from port_bench import common, t23d_parts as parts
from port_bench import trace as trace_mod

TRACED_STEPS = 10
CHECKED_STEPS = 3
WARM_INDEX = 1_000_000
PARTS = ("umt5", "dit")


class _WindowClosed(Exception):
    """Raised by the DiT's pre-hook at the first step past the window."""


class Recorder:
    """The DiT's (x, timesteps, text, output) at each step of one request,
    copied to the host as they are made, so that the benchmark holds none
    of it on the device.  With `like` (the four tensors of a warm step)
    the host buffers are allocated up front, pinned on a card, and each
    copy is queued without a wait; a tensor of another shape or dtype (a
    program at fault) is copied whole instead."""

    def __init__(self, n_steps: int, like: tuple | None = None,
                 pin: bool = False):
        self.bufs = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                      for t in like] for _ in range(n_steps)] \
            if like is not None else None
        self.steps = [[None] * 4 for _ in range(n_steps)]

    def put(self, k: int, j: int, t: torch.Tensor) -> None:
        if k >= len(self.steps):
            return
        b = self.bufs[k][j] if self.bufs is not None else None
        if b is not None and b.shape == t.shape and b.dtype == t.dtype:
            self.steps[k][j] = b.copy_(t, non_blocking=True)
        else:
            self.steps[k][j] = t.detach().to("cpu", copy=True)

    def hooks(self, dit, active):
        """Forward hooks on the DiT that record step k while active()
        gives k (None: not recording)."""
        def pre(module, args):
            k = active()
            if k is not None:
                for j, a in enumerate(args[:3]):
                    self.put(k, j, a)

        def post(module, args, out):
            k = active()
            if k is not None:
                self.put(k, 3, out)
        return [dit.register_forward_pre_hook(pre),
                dit.register_forward_hook(post)]

    def finished(self) -> list:
        """The recorded steps, up to the first one not recorded whole."""
        out = []
        for st in self.steps:
            if any(t is None for t in st):
                break
            out.append(tuple(st))
        return out


def setup(run) -> None:
    from vist3a_tpu_torch.pipelines import t23d

    cfg = parts.program_config(run)
    run.state["cfg"] = cfg
    run.state["tokenize"] = tok = common.tokenizer(
        cfg.umt5.max_sequence_length, cfg.umt5.vocab_size)
    t0 = time.perf_counter()
    run.state["mods"] = mods = parts.build_program(run, cfg, PARTS)
    common.sync(run.device)
    t1 = time.perf_counter()
    # every shape of the traffic: the prompt pair and two CFG steps
    prompt, z = parts.request_inputs(run, cfg, WARM_INDEX)
    cond, uncond = t23d.embed_prompts(mods["umt5"], tok, prompt,
                                      device=run.device)
    warm = Recorder(1)
    hooks = warm.hooks(mods["dit"], lambda: 0)
    t23d.denoise(mods["dit"], cond, uncond,
                 dataclasses.replace(cfg, num_inference_steps=2),
                 latents0=z, device=run.device)
    for h in hooks:
        h.remove()
    run.state["recorder"] = Recorder(
        cfg.num_inference_steps, warm.steps[0],
        pin=torch.device(run.device).type == "cuda")
    parts.log_setup(run, t0, t1)


def checked_steps(run, n_steps: int) -> list[int]:
    return sorted(int(s) for s in common.rng(run.seed, 5).choice(
        n_steps, size=CHECKED_STEPS, replace=False))


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
                    mods["umt5"], run.state["tokenize"], prompt,
                    device=run.device)
                lat = t23d.denoise(dit, cond, uncond, cfg, latents0=z,
                                   device=run.device)
            except _WindowClosed:
                break
            if st["request"] == 0:
                run.state["kept"] = {"cond": cond, "uncond": uncond,
                                     "latents": lat, "noise": z}
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
        # the steps after the profiler stopped, for `mfu.denoise`
        run.counters["untraced_steps"] = st["steps"] - TRACED_STEPS
        run.counters["untraced_s"] = t_end - st["t_untraced"]
    run.state["steps"] = rec.finished()
    if "kept" not in run.state:
        run.failed += 1     # the window finished no request


def free(run) -> None:
    run.state.pop("mods", None)
    common.empty_cache(run.device)


def input_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far an input the program gave its DiT is from the one the
    reference's chain gives, cast to the program's dtype (inf where the
    shapes differ)."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return common.rel(got.to(want.device).float(),
                      want.to(got.dtype).float())


def reference_numbers(run, got: dict) -> dict:
    """The float32 reference of the kept request's stages from the
    benchmark's inputs and the program's own state (see the module's
    docstring), and the numbers compared.  got["steps"] holds the DiT's
    (x, timesteps, text, output) at every step."""
    from port_bench.reference import scene as ref
    from port_bench.reference import unipc, wan_dit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = run.device
    rcfg = ref.config(run.config["t23d"])
    stream = common.WeightStream(run.seed, dev,
                                 run.config["weights"]["overrides"])
    prompt, z = parts.request_inputs(run, rcfg, 0)
    umt5 = ref.build_one(rcfg, "umt5", stream, dev)
    cond, uncond = ref.embed(umt5, run.state["tokenize"], prompt, dev)
    del umt5
    common.empty_cache(dev)
    steps = got["steps"]
    dit = ref.build_one(rcfg, "dit", stream, dev)
    vel = []
    with torch.no_grad():
        for k in checked_steps(run, rcfg.num_inference_steps):
            x, ts, text, out = (t.to(dev) for t in steps[k])
            want = wan_dit.forward(dit, x.float(), ts.float(), text.float())
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
        model_fn = unipc.cfg_model(dit_apply, got["cond"].to(dev).float(),
                                   got["uncond"].to(dev).float(),
                                   rcfg.guidance_scale)
        ucfg = unipc.UniPCConfig(num_steps=rcfg.num_inference_steps,
                                 shift=rcfg.flow_shift)
        chain_rel = common.rel(got["latents"].to(dev),
                               unipc.sample_scan(model_fn, z.float(), ucfg))
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
    kept = run.state.get("kept")
    limits = run.cell["limits"]
    steps = run.state.pop("steps", [])
    if kept is None or len(steps) < run.state["cfg"].num_inference_steps:
        return [(n, float("inf"), limits[n]) for n in limits]
    numbers = reference_numbers(run, {**kept, "steps": steps})
    return [(n, numbers[n], limits[n]) for n in limits]


def control_request(run) -> dict:
    """The control in the program's place: UMT5 and the DiT of the
    reference in bf16 over weights rounded to float8 e4m3, the UniPC state
    in bf16 (one step below the fp32 the sampler states), on request 0;
    its DiT's inputs and outputs recorded as the program's are."""
    from port_bench.reference import scene as ref
    from port_bench.reference import unipc, wan_dit

    rcfg = ref.config(run.config["t23d"], head_dtype="bfloat16")
    stream = common.WeightStream(run.seed, run.device,
                                 run.config["weights"]["overrides"])
    prompt, z = parts.request_inputs(run, rcfg, 0)
    umt5 = ref.build_one(rcfg, "umt5", stream, run.device, torch.bfloat16)
    ref.fp8_round_weights({"umt5": umt5})
    cond, uncond = ref.embed(umt5, run.state["tokenize"], prompt, run.device)
    del umt5
    dit = ref.build_one(rcfg, "dit", stream, run.device, torch.bfloat16)
    ref.fp8_round_weights({"dit": dit})
    steps = []

    def dit_apply(x2, ts, text):
        args = (x2.to(torch.bfloat16), ts, text.to(torch.bfloat16))
        with torch.no_grad():
            out = wan_dit.forward(dit, *args)
        steps.append((*args, out))
        return out

    model_fn = unipc.cfg_model(dit_apply, cond, uncond, rcfg.guidance_scale)
    ucfg = unipc.UniPCConfig(num_steps=rcfg.num_inference_steps,
                             shift=rcfg.flow_shift)
    with torch.no_grad():
        lat = unipc.sample_scan(model_fn, z.to(torch.bfloat16), ucfg)
    del dit
    common.empty_cache(run.device)
    return {"cond": cond, "uncond": uncond, "latents": lat.float(),
            "steps": steps}


def sweep_seed(run, program: bool, control: bool) -> dict:
    """`sweep.py`'s readings for one seed: request 0 untimed through the
    program, and through the control, each judged as a run's check does."""
    from vist3a_tpu_torch.pipelines import t23d

    cfg = parts.program_config(run)
    run.state["cfg"] = cfg
    run.state["tokenize"] = common.tokenizer(cfg.umt5.max_sequence_length,
                                             cfg.umt5.vocab_size)
    numbers = {}
    if program:
        mods = parts.build_program(run, cfg, PARTS)
        rec = Recorder(cfg.num_inference_steps)
        step = [0]

        def count(module, args, out):
            step[0] += 1
        hooks = rec.hooks(mods["dit"], lambda: step[0]) \
            + [mods["dit"].register_forward_hook(count)]
        prompt, z = parts.request_inputs(run, cfg, 0)
        cond, uncond = t23d.embed_prompts(mods["umt5"], run.state["tokenize"],
                                          prompt, device=run.device)
        lat = t23d.denoise(mods["dit"], cond, uncond, cfg, latents0=z,
                           device=run.device)
        for h in hooks:
            h.remove()
        del mods
        common.empty_cache(run.device)
        numbers["program"] = reference_numbers(
            run, {"cond": cond, "uncond": uncond, "latents": lat,
                  "steps": rec.finished()})
    if control:
        numbers["control"] = reference_numbers(run, control_request(run))
    return numbers
