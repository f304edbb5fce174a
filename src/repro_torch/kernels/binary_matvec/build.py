"""Build and load the binary matmul kernels (`csrc/binary_matvec.cu`).

The source is compiled with `nvcc` on first use into a shared library
with a plain C interface, which `ctypes` loads (`repro_torch.kernels.nvcc`
holds the compile, hash and load core that every kernel family shares).

Nothing here runs at import: `nvcc` is reached only when a wrapper is
handed a CUDA tensor, or when `chip_smoke.py` calls `load()`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import BuildInfo, KernelLibrary, build_dir

__all__ = ["SOURCE", "BuildInfo", "LIBRARY", "build_dir", "last_build", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "binary_matvec.cu"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.bmv_matmul_planes.argtypes = [vp, vp, vp, ll, i, vp, i, i, i, i, i, i, i, vp]
    lib.bmv_matmul_planes.restype = i
    lib.bmv_planes_smem_bytes.argtypes = [i, i]
    lib.bmv_planes_smem_bytes.restype = ll
    lib.bmv_matmul.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
    lib.bmv_matmul.restype = i
    lib.bmv_matmul_packed.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
    lib.bmv_matmul_packed.restype = i
    lib.bmv_matmul_mma.argtypes = [vp, vp, i, vp, i, i, i, i, i, i, vp]
    lib.bmv_matmul_mma.restype = i
    lib.bmv_matmul_packed_mma.argtypes = [vp, vp, i, vp, i, i, i, i, i, i, vp]
    lib.bmv_matmul_packed_mma.restype = i
    lib.bmv_forward_planes.argtypes = [vp, i, i, i, i, vp, i, i, i, vp, i, i, vp]
    lib.bmv_forward_planes.restype = i
    lib.bmv_forward_planes_mma.argtypes = [vp, i, i, i, i, vp, i, i, i, vp, i, i, i, i, vp]
    lib.bmv_forward_planes_mma.restype = i
    lib.bmv_forward_mma_smem_bytes.argtypes = [i, i, i]
    lib.bmv_forward_mma_smem_bytes.restype = ll
    lib.bmv_forward_stage_words.argtypes = [i, i]
    lib.bmv_forward_stage_words.restype = ll
    lib.bmv_forward_max_clusters.argtypes = [i, i, ll, i]
    lib.bmv_forward_max_clusters.restype = i
    lib.bmv_error_string.argtypes = [i]
    lib.bmv_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = KernelLibrary("binary_matvec", SOURCE, _bind)


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first when no library for
    the current source exists. Thread-safe; loads once per process."""
    return LIBRARY.load()


def last_build() -> BuildInfo | None:
    """The `BuildInfo` of this process's `load()`, None before it."""
    return LIBRARY.last_build()
