"""Build and load the W8A8 matmul kernel (`csrc/quant_matmul.cu`).

Compiled with `nvcc` on first use into its own shared library with a
plain C interface, which `ctypes` loads (`repro_torch.kernels.nvcc`
holds the compile, hash and load core that every kernel family shares).

Nothing here runs at import: `nvcc` is reached only when the wrapper is
handed a CUDA tensor, or when `chip_smoke.py` calls `load()`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import BuildInfo, KernelLibrary

__all__ = ["SOURCE", "LIBRARY", "last_build", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_matmul.cu"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.qmm_matmul.argtypes = [vp, ll, vp, ll, vp, vp, vp, i, i, i, i, i, vp]
    lib.qmm_matmul.restype = i
    lib.qmm_error_string.argtypes = [i]
    lib.qmm_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = KernelLibrary("quant_matmul", SOURCE, _bind)


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first when no library for
    the current source exists. Thread-safe; loads once per process."""
    return LIBRARY.load()


def last_build() -> BuildInfo | None:
    """The `BuildInfo` of this process's `load()`, None before it."""
    return LIBRARY.last_build()
