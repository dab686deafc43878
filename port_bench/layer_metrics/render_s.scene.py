"""Seconds of the traced scene's orbit render with its device work, from
the program's own spans: the start of `export.render` to the end of
`export.frames_to_host`, whose copy to the host waits for the card
(`kernels/rasterizer.py` through `io/video_export.py`;
`program_spans.render_s`)."""

from port_bench.program_spans import render_s


def read(run):
    return render_s(run)
