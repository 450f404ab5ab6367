"""The kernels' build directory as the port's compilation cache
(``ops/build.py``; ``--compilation-cache-dir``, ``--no-compile-cache``,
``--aot-warmup``) on the CPU: a fake ``nvcc`` on ``PATH`` "compiles" by
copying a shared library that ``ctypes`` can load, and counts its calls.
A cold directory builds (``compile/cache_hit`` 0), the same directory
again builds nothing (1) and gains no file; ``--no-compile-cache``
builds into a private directory that is gone after the run and never
touches the default one; the loaded libraries are kept by path."""

import _ctypes
import json
import os
import stat
import sys

import pytest
import torch

from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch.ops import build

FAKE_NVCC = """#!{python}
import shutil, sys
args = sys.argv[1:]
with open({calls!r}, "a") as f:
    f.write(args[-1] + "\\n")
shutil.copy({lib!r}, args[args.index("-o") + 1])
"""


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: this file's torch
    ops keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """A fake nvcc on PATH, a csrc/ of one source, the default build
    directory in tmp_path; returns the file that logs nvcc's calls."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "nvcc_calls"
    script = bin_dir / "nvcc"
    script.write_text(FAKE_NVCC.format(python=sys.executable,
                                       calls=str(calls),
                                       lib=_ctypes.__file__))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text("// a kernel\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "default"))
    monkeypatch.setattr(build, "_build_dir", str(tmp_path / "default"))
    monkeypatch.setattr(build, "_paths", {})
    monkeypatch.setattr(build, "_loaded", {})
    yield calls
    build.reset_build_dir()


def n_calls(calls) -> int:
    return len(calls.read_text().splitlines()) if calls.exists() else 0


def test_a_directory_misses_then_hits(nvcc, tmp_path):
    build.set_build_dir(str(tmp_path / "cache"))
    path, seconds = build.build("kern")
    assert seconds > 0.0 and n_calls(nvcc) == 1
    assert os.path.dirname(path) == str(tmp_path / "cache")
    assert build.build("kern") == (path, 0.0)           # found built
    lib = build.load("kern")
    assert lib._name == path and build.load("kern") is lib
    assert n_calls(nvcc) == 1
    assert not (tmp_path / "default").exists()


def test_the_library_map_is_keyed_by_path(nvcc, tmp_path):
    """A second directory in the same process loads its own file, never
    the first directory's library."""
    build.set_build_dir(str(tmp_path / "a"))
    lib_a = build.load("kern")
    build.set_build_dir(str(tmp_path / "b"))
    lib_b = build.load("kern")
    assert n_calls(nvcc) == 2
    assert lib_a is not lib_b
    assert lib_a._name.startswith(str(tmp_path / "a"))
    assert lib_b._name.startswith(str(tmp_path / "b"))
    assert os.path.basename(lib_a._name) == os.path.basename(lib_b._name)
    build.set_build_dir(str(tmp_path / "a"))
    assert build.load("kern") is lib_a and n_calls(nvcc) == 2
    build.set_build_dir(None)
    assert build.build_dir() == str(tmp_path / "default")


def test_a_private_directory_is_removed(nvcc, tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    private = build.private_build_dir()
    assert private.startswith(str(tmp_path / "tmp"))
    lib = build.load("kern")
    assert lib._name.startswith(private) and os.path.isdir(private)
    build.reset_build_dir()
    assert not os.path.exists(private)
    assert os.listdir(tmp_path / "tmp") == []
    assert build.build_dir() == str(tmp_path / "default")
    assert not (tmp_path / "default").exists()


def _gauges(rsl) -> dict:
    out = {}
    with open(os.path.join(rsl, "telemetry", "rank0.jsonl")) as f:
        for line in f:
            ev = json.loads(line)
            if ev["kind"] == "gauge":
                out[ev["name"]] = ev["value"]
    return out


def _train(tmp_path, rsl, *extra) -> list:
    return ["train", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / rsl), "--model", "mlp", "--device", "cpu",
            "--debug", "--synthetic-fallback", "-e", "1", "-b", "128",
            "--telemetry", "--aot-warmup", *extra]


def test_the_warmup_records_a_cold_then_a_warm_cache(nvcc, tmp_path,
                                                     monkeypatch):
    """``train --aot-warmup`` with the run's libraries built by the fake
    nvcc: cache_hit 0 on a fresh --compilation-cache-dir, 1 on the second
    run over it with no new file, and --no-compile-cache leaves nothing
    behind."""
    monkeypatch.setattr(tcli, "_run_libraries",
                        lambda cfg, device: ("kern",))
    cache = tmp_path / "cache"
    assert tcli.main(_train(tmp_path, "cold", "--compilation-cache-dir",
                            str(cache))) == 0
    listing = sorted(os.listdir(cache))
    assert n_calls(nvcc) == 1 and len(listing) == 2     # .so and its log
    assert tcli.main(_train(tmp_path, "warm", "--compilation-cache-dir",
                            str(cache))) == 0
    assert n_calls(nvcc) == 1 and sorted(os.listdir(cache)) == listing
    cold, warm = (_gauges(str(tmp_path / r)) for r in ("cold", "warm"))
    assert (cold["compile/cache_hit"], warm["compile/cache_hit"]) == (0, 1)
    assert cold["compile/warmup_s"] > 0 and warm["compile/warmup_s"] > 0
    assert build.build_dir() == str(tmp_path / "default")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    assert tcli.main(_train(tmp_path, "nocache", "--no-compile-cache")) == 0
    assert n_calls(nvcc) == 2
    assert _gauges(str(tmp_path / "nocache"))["compile/cache_hit"] == 0
    assert [n for n in os.listdir(tmp_path / "tmp")
            if n.startswith("dpt-kernels-")] == []
    assert not (tmp_path / "default").exists()
    costs = json.loads((tmp_path / "warm" / "costs.json").read_text())
    assert costs["programs"]["train_step"]["flops"] == \
        128 * costs["programs"]["train_flops_per_sample"]["flops_per_sample"]
