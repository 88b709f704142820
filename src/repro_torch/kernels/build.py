"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface, beside the
headers it includes in its ``csrc/`` directory. On first use ``nvcc``
compiles it for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the root of the checkout, named by the kernel
and a hash of everything the build reads (every file of that directory
and nvcc's flags), and ``ctypes`` loads it. The libraries take raw
device pointers, shapes and the CUDA stream, so they include none of
PyTorch's headers and build in seconds. A build or load error raises.

``build_all`` starts one ``nvcc`` per kernel at once and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Iterable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", *ARCH_FLAGS, "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's kernels are built with the "
                           "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


class CudaLibrary:
    """One kernel source, built once per source hash and loaded once.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's C
    functions after loading."""

    def __init__(self, name: str, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = Path(source)
        self.declare = declare
        self.build_log = ""    # nvcc's output of the last build (ptxas report)
        self._lib = None

    def library_path(self) -> Path:
        """The library's path, keyed by nvcc's flags, the source's name and
        the name and bytes of every file in the source's directory."""
        h = hashlib.sha256("\0".join([*NVCC_FLAGS, self.source.name]).encode())
        for f in sorted(p for p in self.source.parent.iterdir() if p.is_file()):
            h.update(b"\0" + f.name.encode() + b"\0" + f.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def _start(self):
        """Start nvcc unless this source is built; returns (proc, tmp) or None."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True), tmp

    def _finish(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, self.library_path())

    def build(self) -> Path:
        """Compile the kernel unless a library of this source already exists."""
        self._finish(self._start())
        return self.library_path()

    def load(self) -> ctypes.CDLL:
        """The loaded kernel library, built first if needed."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self.declare(lib)
            self._lib = lib
        return self._lib


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build every library at once (one nvcc process each), then load them."""
    libs = list(libs)
    started = [lib._start() for lib in libs]
    errors = []
    for lib, s in zip(libs, started):     # wait for every nvcc, then report
        try:
            lib._finish(s)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for lib in libs:
        lib.load()
