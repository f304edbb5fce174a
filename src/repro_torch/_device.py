"""Device selection for the port: the card unless the caller asks for
the CPU.

Every entry point of `repro_torch` takes `device=None` and resolves it
here. None means `cuda:0` and raises when CUDA is absent; the CPU is
used only when the caller names it, so a run never quietly leaves the
card.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`cuda:0` for None; otherwise the named device. Raises RuntimeError
    for a CUDA device when CUDA is absent, ValueError for a device type
    the port does not run on."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev
