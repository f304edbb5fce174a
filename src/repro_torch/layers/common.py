"""Weight access supporting quantized (int8 + per-channel scale) leaves.

Counterpart of `repro/layers/common.py`. A parameter leaf is either a
tensor or `{"q": int8, "s": fp32}` (per-output-channel scales over the
LAST dim); `wx(w, dtype)` returns the compute-dtype weight either way.
"""
from __future__ import annotations

import torch

__all__ = ["is_q", "wx"]


def is_q(w) -> bool:
    return isinstance(w, dict) and set(w.keys()) == {"q", "s"}


def wx(w, dtype: torch.dtype) -> torch.Tensor:
    """Materialize a weight in compute dtype (dequantizing in fp32 first)."""
    if is_q(w):
        return (w["q"].float() * w["s"]).to(dtype)
    return w.to(dtype)
