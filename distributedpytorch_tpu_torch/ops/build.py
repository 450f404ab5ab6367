"""Builds the port's CUDA C++ sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``<build dir>/<name>-<hash>.so`` (the hash covers the source, every
header under ``csrc/`` and the flags, so an edited source or header
rebuilds), then bound with ``ctypes``.  Nothing is built when a module is
imported: the CPU tests import every module on machines with no ``nvcc``.

The build directory is the port's compilation cache (the counterpart of
the JAX package's persistent XLA cache, ``runtime.py:355-440``): the
default is ``build/kernels`` beside the package; ``--compilation-cache-dir
DIR`` builds into DIR and looks the libraries up there
(``set_build_dir``), and ``--no-compile-cache`` builds into a fresh
private directory that ``reset_build_dir`` removes at the end of the run
(``private_build_dir``).  Loaded libraries are kept by path, so a second
directory in the same process loads its own file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

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
_build_dir = BUILD_DIR
_private_dir: Optional[str] = None     # --no-compile-cache's, removed at end
# (build dir, name) -> library path, and library path -> the loaded library
_paths: Dict[Tuple[str, str], str] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    """The directory the libraries are built into and looked up in."""
    return _build_dir


def set_build_dir(path: Optional[str]) -> None:
    """Build into and look up in ``path`` (None: the default
    ``BUILD_DIR``); a private directory set earlier is removed first."""
    global _build_dir
    reset_build_dir()
    _build_dir = os.path.abspath(path) if path else BUILD_DIR


def private_build_dir() -> str:
    """``--no-compile-cache``: build into a fresh private directory, which
    ``reset_build_dir`` removes (so nothing built lasts past the run)."""
    global _build_dir, _private_dir
    reset_build_dir()
    _private_dir = _build_dir = tempfile.mkdtemp(prefix="dpt-kernels-")
    return _private_dir


def reset_build_dir() -> None:
    """Back to the default directory, removing a private one (its
    libraries stay mapped in this process; a later load builds anew)."""
    global _build_dir, _private_dir
    with _lock:
        if _private_dir is not None:
            shutil.rmtree(_private_dir, ignore_errors=True)
            for key in [k for k in _paths if k[0] == _private_dir]:
                del _paths[key]
            _private_dir = None
        _build_dir = BUILD_DIR


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
    return os.path.join(_build_dir,
                        f"{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> Tuple[str, float]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, seconds spent compiling — 0.0 on a hit).  The
    compiler's register/spill report lands beside the library as
    ``<lib>.log``.  The write is atomic (tmp + rename), so concurrent
    builds in other processes never load a torn library."""
    lib = library_path(name)
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(os.path.dirname(lib), exist_ok=True)
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
    """The loaded library for ``csrc/<name>.cu`` in the current build
    directory, built on first use."""
    with _lock:
        key = (_build_dir, name)
        path = _paths.get(key)
        if path is None:
            path = _paths[key] = build(name)[0]
        lib = _loaded.get(path)
        if lib is None:
            lib = _loaded[path] = ctypes.CDLL(path)
        return lib
