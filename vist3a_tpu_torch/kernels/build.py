"""Build a CUDA source of this package into a shared library and load it.

Each `csrc/*.cu` file exposes a plain C interface, so it compiles with
`nvcc` alone (seconds), without PyTorch's headers, and binds with `ctypes`.
The library goes to `vist3a_tpu_torch/_build/`, named by a hash of the
source, of the `csrc/` headers it includes (`#include "..."`, followed
through the headers' own includes) and of the flags, so an edited source or
header never loads a stale build.  The build happens at first use, never at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output for each library built or loaded in this process (ptxas:
# registers, shared memory and spills of every kernel), also kept beside
# the library as `.log`.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home, "bin", "nvcc")
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels of vist3a_tpu_torch")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def digest(src: Path) -> str:
    """Hash of the source, of every local header it reaches and of the
    flags."""
    h = hashlib.sha256()
    seen: set[Path] = set()

    def add(path: Path) -> None:
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        for name in _LOCAL_INCLUDE.findall(text):
            add((path.parent / name.decode()).resolve())

    add(src.resolve())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(source: str) -> Path:
    """Compile `csrc/<source>` for sm_90a; returns the library's path."""
    src = CSRC_DIR / source
    lib = BUILD_DIR / f"lib{src.stem}-{digest(src)}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        if log.exists():
            build_logs.setdefault(source, log.read_text())
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    build_logs[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{build_logs[source]}")
    log.write_text(build_logs[source])
    os.replace(tmp, lib)
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (once) and load the library of `csrc/<source>`."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]


def build_all(sources: list[str]) -> None:
    """Build several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(build, sources))
