"""The CogVideoX cell's window's peak of allocated device memory, in GB."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
