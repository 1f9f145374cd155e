"""Build csrc/local_sgd.cu with nvcc into a shared library and bind it with
ctypes.

The build itself is the port's shared builder (``repro_torch.kernels._build``):
the library is built at first use into ``build/`` beside this file, named by a
hash of the source and flags.  Nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "local_sgd.cu"

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary(
    SOURCE, "local_sgd",
    {"local_sgd_launch": ([_p, _p, _p, _p, _p, _i, _i, _i, _i, _f, _i, _f, _f, _f, _i, _f, _f,
                           _p], ctypes.c_int),
     "local_sgd_chain_launch": ([_i, _i, _f, _f, _f, _p, _p], ctypes.c_int),
     "local_sgd_probe_launch": ([_p, _p, _p, _p, _p, _i, _i, _i, _i, _f, _i, _f, _f, _f, _i,
                                 _p], ctypes.c_int),
     "local_sgd_plan": ([_i, _p], ctypes.c_int),
     "local_sgd_register_entries": ([_i], ctypes.c_int),
     "local_sgd_max_d": ([], ctypes.c_int)},
    error_fn="local_sgd_error_string")


def load() -> ctypes.CDLL:
    """The built library with its C interface declared."""
    return LIBRARY.load()
