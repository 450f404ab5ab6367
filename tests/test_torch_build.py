"""The port's kernel build (``ops/build.py``) on the CPU: no ``nvcc`` runs
here.  A library's name hashes its source, every header under ``csrc/``
and the flags, so an edit to a shared header rebuilds every source that
may include it instead of loading a stale library."""

import os

import pytest

from distributedpytorch_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of one source and one header in a temporary directory."""
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "kern.cu").write_text('#include "blocks.cuh"\n')
    (tmp_path / "blocks.cuh").write_text("// building blocks\n")
    return tmp_path


def test_a_header_edit_changes_the_library_path(csrc):
    first = build.library_path("kern")
    assert build.library_path("kern") == first        # deterministic
    (csrc / "blocks.cuh").write_text("// building blocks, edited\n")
    edited = build.library_path("kern")
    assert edited != first
    (csrc / "blocks.cuh").write_text("// building blocks\n")
    assert build.library_path("kern") == first


@pytest.mark.parametrize("change", ["new header", "source edit",
                                    "renamed header"])
def test_other_inputs_of_the_build_change_the_library_path(csrc, change):
    first = build.library_path("kern")
    if change == "new header":
        (csrc / "more.h").write_text("// more\n")
    elif change == "source edit":
        (csrc / "kern.cu").write_text('#include "blocks.cuh"\n// edit\n')
    else:
        os.rename(csrc / "blocks.cuh", csrc / "other.cuh")
    assert build.library_path("kern") != first


def test_the_flash_sources_share_the_mma_header():
    """Both flash-attention sources and the conv weight gradient's include
    mma16.cuh (the tensor-core building blocks for bf16 and float16), and
    it is one of the headers every library's hash covers."""
    header = os.path.join(build.CSRC_DIR, "mma16.cuh")
    assert header in build.header_paths()
    for name in ("flash_fwd", "flash_bwd", "conv_dw"):
        with open(build.source_path(name)) as f:
            assert '#include "mma16.cuh"' in f.read(), name
