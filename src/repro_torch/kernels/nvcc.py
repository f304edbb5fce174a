"""Build and load a family's CUDA kernels with nvcc, bound through ctypes.

Each kernel family (`binary_matvec`, `fused_mlp`) keeps one `.cu` source
with a plain C interface. `KernelLibrary.load()` compiles it with `nvcc`
on first use into a shared library and loads it with `ctypes`. The
library's file name carries a hash of the source and the flags, so an
edited `.cu` file builds anew and a stale library is never loaded. The
build goes into the checkout's git-ignored `build/` directory (or
`$REPRO_TORCH_BUILD_DIR`). An nvcc failure raises; nothing falls back.

Nothing here runs at import, since the CPU tests import every module:
`nvcc` is reached only when a wrapper is handed a CUDA tensor, or when
`chip_smoke.py` calls `load()`. Libraries of different families build
independently, so loading them from several threads compiles them in
parallel.
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
from typing import Callable

__all__ = ["NVCC_FLAGS", "BuildInfo", "KernelLibrary", "build_dir"]

_REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo:
    """What a `load()` did: the library path, whether it compiled
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
        "toolkit is needed to build the port's kernels")


def _compile(source: Path, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


class KernelLibrary:
    """One family's kernel library: `source` compiled into
    `build_dir()/<name>-<hash>.so`, its C entry points typed by `bind`.
    Thread-safe; loads once per process."""

    def __init__(self, name: str, source: Path,
                 bind: Callable[[ctypes.CDLL], ctypes.CDLL]):
        self.name = name
        self.source = source
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._info: BuildInfo | None = None

    def load(self) -> ctypes.CDLL:
        """The loaded library, compiling it first when no library for the
        current source exists."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            h = hashlib.sha256(self.source.read_bytes())
            h.update(" ".join(NVCC_FLAGS).encode())
            path = build_dir() / f"{self.name}-{h.hexdigest()[:16]}.so"
            compiled, seconds, log = False, 0.0, ""
            if not path.exists():
                t0 = time.perf_counter()
                log = _compile(self.source, path)
                seconds = time.perf_counter() - t0
                compiled = True
            self._lib = self._bind(ctypes.CDLL(str(path)))
            self._info = BuildInfo(path, compiled, seconds, log)
            return self._lib

    def last_build(self) -> BuildInfo | None:
        """The `BuildInfo` of this process's `load()`, None before it."""
        return self._info
