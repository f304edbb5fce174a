"""Public op of Mamba2's prefill causal conv: `causal_conv(xbc, weight,
bias)`, silu(causal depthwise conv + bias) over (B, S, C) channels.

The wrapper takes its plain version (`ref.causal_conv`) when its tensors
lie on the CPU, returns its fake (an empty output of the kernel's shape
and dtype) on `meta`, and launches the CUDA kernel (`csrc/causal_conv.cu`,
built on first use by `build.py`) when they lie on a CUDA device; a
failed build or launch raises.

The kernel reads xbc in place: any (B, S, C) view whose channels are
packed (stride 1), such as the x|B|C columns of in_proj's output, through
its batch and length strides. Two CUDA routes of one kernel template
(`causal_conv_kernel`), picked here by what the view allows: 16-byte
aligned rows (pointer, strides and C a multiple of 8 elements) go to the
vector route (8 channels a thread), every other view to the element
route (one a thread). The width is Mamba2's 4 (`WIDTH`), the only one the
library holds. xbc is bf16 or fp32; weight and bias are read as fp32 (a
leaf of another dtype is cast first); the output is a packed (B, S, C)
tensor in xbc's dtype. `causal_conv.launches` counts the launches of both
routes, `causal_conv.vec_launches` the vector route's; `reset_launches()`
sets both back to 0.

Under the counting mode (`launch/cost.py`) each call records `work`'s
formula once as kernel "causal_conv", whichever of the kernel, its plain
version or its fake ran.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.launch import check_launch, placement, stream_args
from repro_torch.kernels.causal_conv import ref

__all__ = ["WIDTH", "reset_launches", "causal_conv", "work"]

_DTYPES = (torch.float32, torch.bfloat16)
WIDTH = 4                       # the conv width the kernel holds


def work(B: int, S: int, C: int, W: int, itemsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: W multiply-adds an output element (the
    bias starts the sum; SiLU's few operations are not counted), and one
    read of xbc, one write of the output in xbc's dtype and one read of
    the fp32 weights and bias."""
    return 2 * W * B * S * C, 2 * B * S * C * itemsize + 4 * (W + 1) * C


def reset_launches() -> None:
    """Set the wrapper's launch counts to 0."""
    causal_conv.launches = 0
    causal_conv.vec_launches = 0


def causal_conv(xbc: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """xbc: (B, S, C); weight: (W, C); bias: (C,). Returns (B, S, C) in
    xbc's dtype: silu(sum_i xbc[:, t - W + 1 + i] * weight[i] + bias),
    rows before the start read as zeros."""
    name = "causal_conv"
    if xbc.dim() != 3 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"{name}: want xbc (B,S,C), weight (W,C), bias (C,)")
    B, S, C = xbc.shape
    if weight.shape[1] != C or bias.shape != (C,):
        raise ValueError(f"{name}: shapes disagree: xbc {tuple(xbc.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    kind = placement(name, (xbc, weight, bias), fake=True)
    with _counted(B, S, C, weight.shape[0], xbc.element_size()):
        if kind == "cpu":
            return ref.causal_conv(xbc, weight, bias)
        if kind == "meta":
            return torch.empty((B, S, C), dtype=xbc.dtype, device="meta")
        return _launch(name, xbc, weight, bias)


def _counted(B, S, C, W, itemsize):
    """The active counters' record of one call (`launch/cost.py`)."""
    from repro_torch.launch import cost
    if not cost.active():
        return contextlib.nullcontext()
    flops, bytes_ = work(B, S, C, W, itemsize)
    return cost.kernel("causal_conv", flops=flops, bytes_=bytes_)


def _launch(name, xbc, weight, bias):
    B, S, C = xbc.shape
    W = weight.shape[0]
    if xbc.dtype not in _DTYPES:
        raise TypeError(f"{name}: xbc must be one of {_DTYPES}, got {xbc.dtype}")
    if C > 1 and xbc.stride(2) != 1:
        raise ValueError(f"{name}: xbc's channels must be packed (stride 1)")
    if W != WIDTH:
        raise ValueError(f"{name}: width {W}; the kernel holds width {WIDTH}")
    from repro_torch.kernels.causal_conv import build

    lib = build.load()
    w = weight.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    out = torch.empty((B, S, C), dtype=xbc.dtype, device=xbc.device)
    if out.numel() == 0:
        return out
    bf16 = int(xbc.dtype == torch.bfloat16)
    sb, sl = xbc.stride(0), xbc.stride(1)
    vec = lib.causal_conv_vec_ok(bf16, xbc.data_ptr(), sb, sl, w.data_ptr(), b.data_ptr(), C)
    device, stream = stream_args(xbc)
    err = lib.causal_conv(bf16, vec, xbc.data_ptr(), sb, sl, w.data_ptr(), b.data_ptr(),
                          out.data_ptr(), B, S, C, W, device, stream)
    check_launch(err, lib.causal_conv_error_string, name)
    causal_conv.launches += 1
    causal_conv.vec_launches += int(vec)
    return out


reset_launches()
