"""Build csrc/sdca.cu with nvcc into a shared library and bind it with ctypes.

The library is built at first use, into ``build/`` beside this file (listed
in .gitignore), under a name that carries a hash of the source, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing is built
or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "sdca.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building the SDCA kernel needs the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsdca_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernel if its library is missing.  Returns the library's
    path, the seconds nvcc took (0 when it was already built) and the
    compiler's report of registers and shared memory."""
    lib = library_path()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "log": proc.stdout + proc.stderr}


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its C interface declared."""
    lib = ctypes.CDLL(build()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sdca_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, f, i, f, p]
    lib.sdca_launch.restype = ctypes.c_int
    lib.sdca_error_string.argtypes = [ctypes.c_int]
    lib.sdca_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return f"{code} ({load().sdca_error_string(code).decode()})"
