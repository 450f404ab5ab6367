"""Builds the port's CUDA C++ sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/kernels/<name>-<hash>.so`` next to the package (the hash covers
the source, every header under ``csrc/`` and the flags, so an edited
source or header rebuilds), then bound with ``ctypes``.  Nothing is built
when a module is imported: the CPU tests import every module on machines
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# --split-compile=0 optimises the device code on every host thread.  In
# chip_smoke.py's parallel build (an 8-core host with an H100)
# flash_fwd.cu took 69.9 s without it and 15.9 s with it; every kernel
# kept its registers but one scalar conv_dw kernel (48 -> 40).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (not on PATH, not at "
                       f"{default}): the CUDA kernels cannot be built")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def header_paths() -> list:
    """The headers under ``csrc/`` (``*.cuh``, ``*.h``), sorted: any
    source may include them."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cuh", ".h")))


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source,
    each header's name and text, and the flags."""
    digest = hashlib.sha256()
    for path in [source_path(name)] + header_paths():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> Tuple[str, float]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, seconds spent compiling — 0.0 on a hit).  The
    compiler's register/spill report lands beside the library as
    ``<lib>.log``.  The write is atomic (tmp + rename), so concurrent
    builds in other processes never load a torn library."""
    lib = library_path(name)
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source_path(name)} "
                           f"(exit {proc.returncode}): "
                           f"{(proc.stderr or proc.stdout).strip()[-2000:]}")
    os.replace(tmp, lib)
    return lib, seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
