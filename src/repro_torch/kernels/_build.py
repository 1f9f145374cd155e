"""Build a kernel source with nvcc into a shared library and bind it with ctypes.

One builder for every hand-written kernel of the port.  A library is built at
first use, into a ``build/`` directory beside its source (listed in
.gitignore), under a name that carries a hash of the source, the headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  Nothing is built or loaded when a module
is imported: the CPU tests import every module, and a machine without a card
may have no CUDA toolkit.

Every source exposes a plain C interface: launch functions that return a
``cudaError_t`` as an int, and an error-string function.  Builds of different
libraries may run at the same time (one nvcc process each), which is how
``chip_smoke.py`` builds all kernels together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# shared memory one block may use on an H100 (227 KB, after opting in)
MAX_SMEM_PER_BLOCK = 232_448

# a C function's (argument types, result type)
Signature = Tuple[Sequence[type], Optional[type]]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building the port's kernels needs the CUDA toolkit")


class KernelLibrary:
    """One CUDA source built into one shared library.

    ``signatures`` maps each C function the port calls to its ctypes
    signature; ``error_fn`` names the function that turns an error code into
    text; ``includes`` lists the headers the source includes, which the
    library's name hashes with it."""

    def __init__(self, source: Path, stem: str, signatures: Dict[str, Signature],
                 error_fn: str, includes: Sequence[Path] = ()):
        self.source = Path(source)
        self.includes = tuple(Path(p) for p in includes)
        self.stem = stem
        self.signatures = dict(signatures)
        self.error_fn = error_fn
        self.build_dir = self.source.parent.parent / "build"
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        text = b"".join(p.read_bytes() for p in (self.source, *self.includes))
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
        return self.build_dir / f"lib{self.stem}_{digest.hexdigest()[:16]}.so"

    def build(self) -> dict:
        """Compile the source if its library is missing.  Returns the
        library's path, the seconds nvcc took (0 when it was already built)
        and the compiler's report of registers and shared memory."""
        lib = self.library_path()
        if lib.exists():
            return {"path": str(lib), "seconds": 0.0, "log": ""}
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
        return {"path": str(lib), "seconds": seconds, "log": proc.stdout + proc.stderr}

    def load(self) -> ctypes.CDLL:
        """The built library with its C interface declared (built first if
        needed; loaded once)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build()["path"])
                for name, (argtypes, restype) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                err = getattr(lib, self.error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def error_string(self, code: int) -> str:
        return f"{code} ({getattr(self.load(), self.error_fn)(code).decode()})"

    def check(self, code: int, what: str) -> None:
        """Raise if a launch function returned an error."""
        if code != 0:
            raise RuntimeError(f"{what} launch failed: {self.error_string(code)}")
