"""What every kernel wrapper of the port checks before a launch.

A wrapper sends CPU tensors to its plain version and CUDA tensors to its
kernel (`placement`); the kernel takes contiguous operands
(`check_contiguous`), launches on PyTorch's current stream
(`stream_args`), and reports its launch error, which the wrapper raises
(`check_launch`).
"""
from __future__ import annotations

import torch

__all__ = ["BLOCK_ROWS", "SMEM_LIMIT", "check_block_rows", "check_contiguous",
           "check_launch", "check_weights", "placement",
           "stream_args"]

# Rows per block the kernels are instantiated for (`bm`).
BLOCK_ROWS = (1, 2, 4, 8, 16, 32)
SMEM_LIMIT = 232_448                    # bytes a block may opt in to (H100)


def placement(name: str, tensors) -> str:
    """'cpu' or 'cuda' for a set of operands that must share a device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device type {kind!r}")
    return kind


def check_contiguous(name: str, tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_weights(name: str, w: torch.Tensor) -> torch.Tensor:
    """Raise TypeError unless the weights are int8 or int32; returns w."""
    if w.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"{name}: weights must be int8 or int32, got {w.dtype}")
    return w


def check_block_rows(name: str, bm: int) -> int:
    if bm not in BLOCK_ROWS:
        raise ValueError(f"{name}: bm={bm} not in {BLOCK_ROWS}")
    return int(bm)


def stream_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a launch beside `t`."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, error_string, name: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error;
    `error_string` is the library's code -> message function."""
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
