"""The peak of allocated device memory over the window's first scene, in
GB: read when that scene ends, before the benchmark keeps any scene's
outputs for its check, so it is the program's own memory."""


def read(run):
    peak = run.counters.get("scene_peak_bytes")
    return peak / 1e9 if peak else None
