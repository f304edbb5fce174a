"""Plain PyTorch versions of the W8A8 quantized matmul.

Counterpart of `repro/kernels/quant_matmul/ref.py`. Semantics:

    y = (x_q @ w_q) * sx * sw[None, :]

x_q int8 (M, K) with a per-tensor activation scale sx (fp32 scalar),
w_q int8 (K, N) with per-output-channel scales sw (N,) fp32; the sum is
exact in int32 and the dequantization is fp32, in that order.
"""
from __future__ import annotations

import torch

__all__ = ["int_matmul", "quant_matmul_ref", "qlinear_ref", "quantize_act_ref",
           "quantize_weight_ref"]


def int_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sum x_q @ w_q. Computed as a float64 product, which
    is exact here (|acc| <= K * 127^2, far below 2^53) and runs on the CPU
    and on the card alike (CUDA has no integer matmul)."""
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)


def quant_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, sx, sw: torch.Tensor
                     ) -> torch.Tensor:
    return int_matmul(x_q, w_q).float() * sx * sw[None, :]


def qlinear_ref(x: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """`ops.qlinear` on plain tensors: quantize x per tensor, int8 product,
    dequantize, cast back to x's dtype."""
    x_q, sx = quantize_act_ref(x)
    return quant_matmul_ref(x_q, w_q, sx, sw).to(x.dtype)


def quantize_act_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization of activations, computed in
    x's dtype as the reference does; the scale is returned in fp32."""
    amax = torch.clamp_min(torch.max(torch.abs(x)), 1e-8)
    s = amax / 127.0
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.float()


def quantize_weight_ref(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of weights (K, N)."""
    amax = torch.clamp_min(torch.amax(torch.abs(w), dim=0), 1e-8)   # (N,)
    s = amax / 127.0
    q = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    return q, s.float()
