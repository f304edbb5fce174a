"""Plain PyTorch version of the fused two-layer kernel.

Counterpart of `repro/kernels/fused_mlp/ref.py`. Runs on any device: the
wrapper in `ops.py` sends CPU tensors here, and `chip_smoke.py` runs it
on the card to check and to time the CUDA kernel against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binary_matvec.ref import binary_matmul

__all__ = ["fused_mlp_predict"]


def fused_mlp_predict(x_uint8: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor, *, threshold: int) -> torch.Tensor:
    """The whole paper network: binarize `x > threshold`, layer 1 over w1
    (K, H), strict step `> 0`, layer 2 over w2 (H, O), argmax (the first
    maximum wins). Each layer is a masked column sum taken in int64 and
    wrapped to int32 like the kernel. Returns int32 class ids (B,)."""
    a = x_uint8.to(torch.int32) > threshold
    hi = binary_matmul(a, w1)
    fi = binary_matmul(hi > 0, w2)
    return torch.argmax(fi, dim=-1).to(torch.int32)
