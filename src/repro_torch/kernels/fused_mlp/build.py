"""Build and load the fused two-layer kernel (`csrc/fused_mlp.cu`).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_mlp.cu"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fmlp_predict.argtypes = [vp, i, i, i, vp, i, vp, i, vp, i, i, vp]
    lib.fmlp_predict.restype = i
    lib.fmlp_predict_mma.argtypes = [vp, i, i, i, vp, i, i, vp, i, i, vp, i, vp]
    lib.fmlp_predict_mma.restype = i
    lib.fmlp_mma_smem_bytes.argtypes = [i, i]
    lib.fmlp_mma_smem_bytes.restype = ctypes.c_longlong
    lib.fmlp_error_string.argtypes = [i]
    lib.fmlp_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = KernelLibrary("fused_mlp", SOURCE, _bind)


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first when no library for
    the current source exists. Thread-safe; loads once per process."""
    return LIBRARY.load()


def last_build() -> BuildInfo | None:
    """The `BuildInfo` of this process's `load()`, None before it."""
    return LIBRARY.last_build()
