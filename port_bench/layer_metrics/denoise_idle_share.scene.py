"""The share of the 1.3B denoise (the program's `t23d.denoise` span: 50
UniPC steps over the DiT, `diffusion/unipc.py`, `nn/wan_dit.py`) in which
the card is idle: the card's busy time inside the traced scene's span
against that span's length untraced, from the warm-up scene's steps
(`program_spans.denoise_idle_share`)."""

from port_bench.program_spans import denoise_idle_share


def read(run):
    return denoise_idle_share(run)
