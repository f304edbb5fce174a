"""Build and load the causal conv kernel (`csrc/causal_conv.cu`).

Compiled with `nvcc` on first use into its own shared library with a
plain C interface, which `ctypes` loads (`repro_torch.kernels.nvcc`
holds the compile, hash and load core that every kernel family shares).

Nothing here runs at import: `nvcc` is reached only when the wrapper is
handed a CUDA tensor.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import BuildInfo, KernelLibrary

__all__ = ["SOURCE", "LIBRARY", "last_build", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "causal_conv.cu"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.causal_conv.argtypes = [i, i, vp, ll, ll, vp, vp, vp, i, i, i, i, i, vp]
    lib.causal_conv.restype = i
    lib.causal_conv_vec_ok.argtypes = [i, vp, ll, ll, vp, vp, i]
    lib.causal_conv_vec_ok.restype = i
    lib.causal_conv_error_string.argtypes = [i]
    lib.causal_conv_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = KernelLibrary("causal_conv", SOURCE, _bind)


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first when no library for
    the current source exists. Thread-safe; loads once per process."""
    return LIBRARY.load()


def last_build() -> BuildInfo | None:
    """The `BuildInfo` of this process's `load()`, None before it."""
    return LIBRARY.last_build()
