"""The port's kernel builder keys each library by everything the build
reads: nvcc's flags and every file of the kernel's ``csrc/`` directory, so
a changed header or flag never loads a stale library. No nvcc is needed to
compute the key."""

import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.sgns import ops as sgns_ops
from repro_torch.kernels.ssm_scan import ops as ssd_ops


def _kernel_dir(tmp_path: Path) -> Path:
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\nextern "C" int k_launch() { return K; }\n')
    (csrc / "k.cuh").write_text("#define K 1\n")
    return csrc


def _lib(csrc: Path) -> CudaLibrary:
    return CudaLibrary("k", csrc / "k.cu", lambda lib: None)


def test_library_path_changes_with_a_header(tmp_path):
    csrc = _kernel_dir(tmp_path)
    before = _lib(csrc).library_path()
    assert _lib(csrc).library_path() == before          # same inputs, same library
    (csrc / "k.cuh").write_text("#define K 2\n")
    after = _lib(csrc).library_path()
    assert after != before
    assert after.parent == build.BUILD_DIR and after.name.startswith("libk_")


def test_library_path_changes_with_a_new_file_in_csrc(tmp_path):
    csrc = _kernel_dir(tmp_path)
    before = _lib(csrc).library_path()
    (csrc / "extra.cuh").write_text("// included by a later edit\n")
    assert _lib(csrc).library_path() != before


def test_library_path_changes_with_nvcc_flags(tmp_path, monkeypatch):
    csrc = _kernel_dir(tmp_path)
    before = _lib(csrc).library_path()
    monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-I/usr/local/cutlass/include"])
    assert _lib(csrc).library_path() != before


@pytest.mark.parametrize("lib", [sgns_ops.LIBRARY, fa_ops.LIBRARY, ssd_ops.LIBRARY],
                         ids=lambda lib: lib.name)
def test_library_path_is_keyed_by_contents_not_location(tmp_path, lib):
    """A copy of a kernel's csrc/ elsewhere maps to the same library; a
    change to any one of its files (the flash kernel's sm90.cuh included)
    maps to another."""
    copy = tmp_path / "csrc"
    shutil.copytree(lib.source.parent, copy)
    moved = CudaLibrary(lib.name, copy / lib.source.name, lib.declare)
    assert moved.library_path() == lib.library_path()
    for f in sorted(copy.iterdir()):
        saved = f.read_bytes()
        f.write_bytes(saved + b"\n")
        assert moved.library_path() != lib.library_path(), f.name
        f.write_bytes(saved)
    assert moved.library_path() == lib.library_path()
