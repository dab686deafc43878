"""What the drivers of the text→3DGS cells share: the program built as
deployed with the seed's weights, each request's inputs, the benchmark's
spans, and the plain reference's modules."""

from __future__ import annotations

import contextlib
import sys
import time

import torch
from torch.profiler import record_function

from port_bench import common


def program_config(run):
    from vist3a_tpu_torch.pipelines import t23d

    return common.from_dict(t23d.T23DConfig(), run.config["t23d"])


def build_program(run, cfg, parts=("umt5", "dit", "vae", "stitched")):
    """The program's modules, as deployed: UMT5, the DiT and the VAE in
    bf16, the stitched decoder's trunk in bf16 and its heads and stitch
    conv in fp32; every parameter from the seed (`common.fill_weights`)."""
    from vist3a_tpu_torch.nn import umt5, wan_dit, wan_vae
    from vist3a_tpu_torch.nn.encoder import cast_trunk_bf16
    from vist3a_tpu_torch.stitch import chopped_anysplat as ca

    makers = {"umt5": lambda: umt5.UMT5Encoder(cfg.umt5),
              "dit": lambda: wan_dit.WanDiT(cfg.dit),
              "vae": lambda: wan_vae.WanVAEDecoder(cfg.vae),
              "stitched": lambda: ca.StitchedDecoder(cfg.stitched)}
    mods = {}
    for name in parts:
        with torch.device("meta"):
            m = makers[name]()
        if name == "stitched":
            m = m.to_empty(device=run.device)
            cast_trunk_bf16(m.encoder)
        else:
            m = m.to(torch.bfloat16).to_empty(device=run.device)
        mods[name] = m.eval().requires_grad_(False)
    common.fill_weights(mods, run.seed, run.config["weights"]["overrides"],
                        run.device)
    return mods


def request_inputs(run, cfg, i: int):
    """(prompt, noise) of request i: the same sizes for every seed."""
    traffic = run.cell["traffic_params"]
    if (traffic["loop"], traffic["clients"], traffic["batch"]) != \
            ("closed", 1, 1):
        raise ValueError(f"the drivers serve one client in a closed loop at "
                         f"B = 1, not {traffic}")
    plist = common.prompts(traffic["prompts"])
    prompt = plist[int(common.rng(run.seed, 1, i).integers(len(plist)))]
    gen = torch.Generator(device=run.device).manual_seed(
        common.torch_seed(run.seed, 2, i))
    z = torch.randn(cfg.latent_shape, generator=gen, device=run.device)
    return prompt, z


@contextlib.contextmanager
def span(run, name: str, i: int):
    with record_function(name):
        t0 = time.perf_counter()
        yield
        if run.trace:
            common.sync(run.device)
        run.spans.append((name, t0, time.perf_counter(), i))


def ref_modules(run, dtype, head_dtype, fp8):
    from port_bench.reference import scene as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcfg = ref.config(run.config["t23d"], head_dtype=head_dtype)
    mods = ref.build(rcfg, ("umt5", "dit", "vae", "stitched"), run.seed,
                     run.config["weights"]["overrides"], run.device, dtype)
    if fp8:
        ref.fp8_round_weights(mods)
    return rcfg, mods




def log_setup(run, t_build: float, t_built: float) -> None:
    """Where set-up went, on standard error: before the program was built
    (imports, the card), building it with the seed's weights, warming."""
    common.sync(run.device)
    now = time.perf_counter()
    print(f"setup: before the build {t_build - run.t_start:.3f} s, build "
          f"and weights {t_built - t_build:.3f} s, warm-up "
          f"{now - t_built:.3f} s", file=sys.stderr, flush=True)


def launch_counts() -> dict:
    """The program's launch counters of its flash and composite kernels."""
    from vist3a_tpu_torch.kernels import flash_attention as fa
    from vist3a_tpu_torch.kernels import rasterizer as tr

    return {"flash_natural": fa.launches_natural,
            "flash_unmasked": fa.launches_unmasked,
            "flash_masked": fa.launches_masked, "composite": tr.launches}
