"""Plain PyTorch version of Mamba2's prefill causal conv.

The composed code the mixer (`layers/mamba2.py` `mamba_mixer`) ran before
the kernel, moved as it was: the input zero-padded by W - 1 rows at the
start, W shifted products in the input's dtype with the weights cast to
it, summed in order, the bias added in that dtype, SiLU in fp32 and one
rounding back. Every product and partial sum is so rounded to bf16 in
bf16 compute; the kernel (`ops.causal_conv` on the card) sums in fp32 and
rounds once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["causal_conv"]


def causal_conv(xbc: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """xbc: (B, S, C); weight: (W, C); bias: (C,). Returns
    silu(sum_i xbc[:, t - W + 1 + i] * weight[i] + bias), rows before the
    start read as zeros, (B, S, C) in xbc's dtype."""
    dt_ = xbc.dtype
    S = xbc.shape[1]
    conv_w = weight.to(dt_)                                       # (W, conv_dim)
    W = conv_w.shape[0]
    pads = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pads[:, i:i + S, :] * conv_w[i][None, None, :] for i in range(W))
    conv = conv + bias.to(dt_)
    return F.silu(conv.float()).to(dt_)
