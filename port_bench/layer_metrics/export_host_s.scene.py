"""Seconds of the traced scene's export work on the host, from the
program's own spans: `export.colour_uint8`, `export.turbo_uint8`,
`export.mp4_write` (`io/video_export.py`) and `export.ply`
(`io/ply_export.py`) summed (`program_spans.export_host_s`)."""

from port_bench.program_spans import export_host_s


def read(run):
    return export_host_s(run)
