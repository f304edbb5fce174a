"""Build and load the bit-plane CUDA kernels (`csrc/binary_matvec.cu`).

The source is compiled with `nvcc` on first use into a shared library
with a plain C interface, which `ctypes` loads. The library's file name
carries a hash of the source and the flags, so an edited `.cu` file
builds anew and a stale library is never loaded. The build goes into the checkout's
git-ignored `build/` directory (or `$REPRO_TORCH_BUILD_DIR`).

Nothing here runs at import, since the CPU tests import every module:
`nvcc` is reached only when a wrapper is handed a CUDA tensor, or when
`chip_smoke.py` calls `load()`.
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

__all__ = ["SOURCE", "BuildInfo", "build_dir", "last_build", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "binary_matvec.cu"
_REPO_ROOT = Path(__file__).resolve().parents[4]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_info: "BuildInfo | None" = None


class BuildInfo:
    """What the last `load()` did: the library path, whether it compiled
    (False when an up-to-date library was already on disk), the seconds
    the compile took, and nvcc's register/shared-memory report."""

    def __init__(self, path: Path, compiled: bool, seconds: float, log: str):
        self.path = path
        self.compiled = compiled
        self.seconds = seconds
        self.log = log


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _REPO_ROOT / "build"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (on PATH or under $CUDA_HOME/bin): the CUDA "
        "toolkit is needed to build the bit-plane kernels")


def _compile(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bmv_matmul_planes.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    lib.bmv_matmul_planes.restype = i
    lib.bmv_forward_planes.argtypes = [
        vp, i, i, i, i, i, vp, vp, vp, vp, vp, i, vp, i, i, vp]
    lib.bmv_forward_planes.restype = i
    lib.bmv_error_string.argtypes = [i]
    lib.bmv_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first when no library for
    the current source exists. Thread-safe; loads once per process."""
    global _lib, _info
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(SOURCE.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()[:16]
        path = build_dir() / f"binary_matvec-{digest}.so"
        compiled, seconds, log = False, 0.0, ""
        if not path.exists():
            t0 = time.perf_counter()
            log = _compile(path)
            seconds = time.perf_counter() - t0
            compiled = True
        _lib = _bind(ctypes.CDLL(str(path)))
        _info = BuildInfo(path, compiled, seconds, log)
        return _lib


def last_build() -> BuildInfo | None:
    """The `BuildInfo` of this process's `load()`, None before it."""
    return _info
