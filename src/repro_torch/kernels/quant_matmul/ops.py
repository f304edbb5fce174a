"""Public ops of the W8A8 quantized matmul kernel.

Counterpart of `repro/kernels/quant_matmul/ops.py`. `quant_matmul` takes
its plain version (`ref.py`) when its tensors lie on the CPU, and
launches the CUDA kernel (`csrc/quant_matmul.cu`, built on first use by
`build.py`) when they lie on a CUDA device; a failed build or launch
raises. `qlinear` quantizes the activation per tensor, runs the int8
product against pre-quantized weights and returns x's dtype. Launches
are counted in `quant_matmul.launches`, which `reset_launches()` sets
back to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.launch import check_contiguous, check_launch, placement, stream_args
from repro_torch.kernels.quant_matmul import ref

__all__ = ["quant_matmul", "quantize_act", "quantize_weight", "qlinear", "reset_launches"]


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    quant_matmul.launches = 0


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx, sw: torch.Tensor
                 ) -> torch.Tensor:
    """y = (x_q @ w_q) * sx * sw. x_q int8 (M, K); w_q int8 (K, N); sx an
    fp32 scalar (a one-element tensor on the operands' device, or a
    number); sw fp32 (N,). Returns fp32 (M, N)."""
    name = "quant_matmul"
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0] \
            or sw.shape != (w_q.shape[1],):
        raise ValueError(f"{name}: want x_q (M, K), w_q (K, N), sw (N,); got "
                         f"{tuple(x_q.shape)}, {tuple(w_q.shape)}, {tuple(sw.shape)}")
    if not isinstance(sx, torch.Tensor):
        sx = torch.tensor(sx, dtype=torch.float32, device=x_q.device)
    if sx.numel() != 1:
        raise ValueError(f"{name}: sx must be one scale, got shape {tuple(sx.shape)}")
    if placement(name, (x_q, w_q, sx, sw)) == "cpu":
        return ref.quant_matmul_ref(x_q, w_q, sx.reshape(()), sw)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"{name}: x_q and w_q must be int8, got {x_q.dtype}, {w_q.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"{name}: sx and sw must be float32, got {sx.dtype}, {sw.dtype}")
    check_contiguous(name, (x_q, w_q, sw))
    (m, k), n = x_q.shape, w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    from repro_torch.kernels.quant_matmul import build

    lib = build.load()
    device, stream = stream_args(x_q)
    err = lib.qmm_matmul(x_q.data_ptr(), w_q.data_ptr(), sx.reshape(1).data_ptr(),
                         sw.data_ptr(), out.data_ptr(), m, n, k, device, stream)
    check_launch(err, lib.qmm_error_string, name)
    quant_matmul.launches += 1
    return out


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.quantize_act_ref(x)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.quantize_weight_ref(w)


def qlinear(x: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """fp activation in, fp out; weights already int8 + per-channel scales."""
    x_q, sx = ref.quantize_act_ref(x)
    return quant_matmul(x_q, w_q, sx, sw).to(x.dtype)


reset_launches()
