"""int8 gradient compression with error feedback.

Counterpart of `repro/optim/compression.py`. Quantizing a gradient to
int8 with per-block scales cuts the bytes of a cross-host all-reduce 4x
against fp32; the quantization error is kept in a local buffer and added
back at the next step, so the compression is unbiased over time
(Karimireddy et al. 2019). `quantize_int8`, `dequantize_int8` and
`compress_decompress` (one error-feedback round, the lossy channel
modelled locally) are the reference's arithmetic: blocks of 2048,
scale = max(max |x|, 1e-12) / 127, round half to even, clip to +-127.
`compressed_psum` needs a collective over a mesh axis and waits for the
port's meshes (ROADMAP.md, A.7).
"""
from __future__ import annotations

import math

import torch

__all__ = ["BLOCK", "quantize_int8", "dequantize_int8", "compress_decompress",
           "compressed_psum"]

BLOCK = 2048


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. Returns (q int8 (n_blocks, BLOCK), scales
    fp32 (n_blocks, 1))."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    amax = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True), 1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def compress_decompress(x: torch.Tensor, err: torch.Tensor):
    """One error-feedback round locally: returns (what the wire carries,
    decoded, in x's dtype; the new error buffer)."""
    xc = x.float() + err
    q, s = quantize_int8(xc)
    decoded = dequantize_int8(q, s, x.shape, torch.float32)
    return decoded.to(x.dtype), xc - decoded


def compressed_psum(x: torch.Tensor, axis_name: str, err: torch.Tensor):
    """The int8-compressed sum over a mesh axis: not ported."""
    raise NotImplementedError(
        "compressed_psum needs a collective over a device mesh, which the port does not "
        "have yet (ROADMAP.md, A.7: meshes)")
