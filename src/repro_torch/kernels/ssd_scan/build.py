"""Build and load the SSD scan kernel (`csrc/ssd_scan.cu`).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan.argtypes = [i, vp, ll, ll, vp, ll, ll, vp, vp, ll, ll, vp, ll, ll,
                             vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.ssd_scan.restype = i
    lib.ssd_scan_mma.argtypes = lib.ssd_scan.argtypes[1:]
    lib.ssd_scan_mma.restype = i
    lib.ssd_smem_bytes.argtypes = [i, i, i]
    lib.ssd_smem_bytes.restype = ll
    lib.ssd_mma_smem_bytes.argtypes = [i, i, i]
    lib.ssd_mma_smem_bytes.restype = ll
    lib.ssd_mma_supported.argtypes = [i, i, i]
    lib.ssd_mma_supported.restype = i
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = KernelLibrary("ssd_scan", SOURCE, _bind)


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first when no library for
    the current source exists. Thread-safe; loads once per process."""
    return LIBRARY.load()


def last_build() -> BuildInfo | None:
    """The `BuildInfo` of this process's `load()`, None before it."""
    return LIBRARY.last_build()
