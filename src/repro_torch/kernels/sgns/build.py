"""Build and load the SGNS lifetime kernel (``csrc/sgns_lifetime.cu``).

On first use ``nvcc`` compiles the source for ``sm_90a`` into a shared
library with a plain C interface, under ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the source; ``ctypes`` loads it.
The library takes raw device pointers, shapes and the CUDA stream, so it
does not include PyTorch's headers and builds in seconds. A build or load
error raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "sgns_lifetime.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None
build_log = ""     # nvcc's output of the last build (ptxas register/smem report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the SGNS kernel is built with the "
                           "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsgns_lifetime_{digest}.so"


def build() -> Path:
    """Compile the kernel unless a library of this source already exists."""
    global build_log
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-O3", *ARCH_FLAGS, "-std=c++17", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sgns_lifetime_launch.argtypes = (
            [ptr] * 8 + [i32] * 6 + [ctypes.c_float, ptr])
        lib.sgns_lifetime_launch.restype = i32
        lib.sgns_lifetime_smem_bytes.argtypes = [i32] * 5
        lib.sgns_lifetime_smem_bytes.restype = ctypes.c_size_t
        lib.sgns_lifetime_max_cols.argtypes = []
        lib.sgns_lifetime_max_cols.restype = i32
        lib.sgns_lifetime_error_string.argtypes = [i32]
        lib.sgns_lifetime_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
