"""Public op of the fused two-layer kernel.

Counterpart of `repro/kernels/fused_mlp/ops.py`. The wrapper takes its
plain version (`ref.py`) when its tensors lie on the CPU, and launches
the CUDA kernel (`csrc/fused_mlp.cu`, built on first use by `build.py`)
when they lie on a CUDA device; a failed build or launch raises. It
counts its launches in `fused_mlp_predict.launches`, which
`reset_launches()` sets back to 0. A shape whose activations the
kernel's shared memory cannot hold is refused on every device, so the
CPU refuses what the card would.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_mlp import ref
from repro_torch.kernels.launch import (
    SMEM_LIMIT, check_block_rows, check_contiguous, check_launch, int32_weights,
    placement, stream_args,
)

__all__ = ["FUSED_BM", "check_fused", "fused_mlp_predict", "fused_smem_bytes",
           "reset_launches"]

FUSED_BM = 2                # default rows per block
_LANES = 32


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    fused_mlp_predict.launches = 0


def fused_smem_bytes(k: int, h: int, o: int, bm: int) -> int:
    """Dynamic shared memory of one block: the tile's packed inputs and
    hidden activations, and its (bm, o) class scores."""
    return 4 * bm * (-(-k // _LANES) + -(-h // _LANES) + o)


def check_fused(k: int, h: int, o: int, bm: int | None = None) -> int:
    """Raise ValueError when the kernel cannot take a K-H-O net at `bm`
    rows per block; returns bm (the default filled in)."""
    name = "fused_mlp_predict"
    bm = check_block_rows(name, FUSED_BM if bm is None else bm)
    if o < 1:
        raise ValueError(f"{name}: want at least one class, got {o}")
    smem = fused_smem_bytes(k, h, o, bm)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} B of shared memory at bm={bm} "
                         f"exceeds {SMEM_LIMIT} B ({k}-{h}-{o} net)")
    return bm


def fused_mlp_predict(x_uint8: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor, *, threshold: int,
                      bm: int | None = None) -> torch.Tensor:
    """Predictions for a batch, the whole 2-layer net in one launch.

    x_uint8: uint8 (B, K); w1: (K, H) and w2: (H, O), int8 or int32 (int8
    cast to int32). Binarize `x > threshold`, layer 1, strict step, layer
    2, argmax (the first maximum wins). Returns int32 (B,). `bm` is the
    rows per block of the CUDA launch (one of BLOCK_ROWS).
    """
    name = "fused_mlp_predict"
    if x_uint8.dtype != torch.uint8 or x_uint8.dim() != 2:
        raise ValueError(f"{name}: want uint8 (B, K) images")
    w1, w2 = int32_weights(name, w1), int32_weights(name, w2)
    if w1.dim() != 2 or w2.dim() != 2 or x_uint8.shape[1] != w1.shape[0] \
            or w1.shape[1] != w2.shape[0]:
        raise ValueError(
            f"{name}: want x (B, K), w1 (K, H), w2 (H, O); got "
            f"{tuple(x_uint8.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    (b, k), (h, o) = x_uint8.shape, w2.shape
    bm = check_fused(k, h, o, bm)
    if placement(name, (x_uint8, w1, w2)) == "cpu":
        return ref.fused_mlp_predict(x_uint8, w1, w2, threshold=threshold)
    check_contiguous(name, (x_uint8, w1, w2))
    out = torch.empty((b,), dtype=torch.int32, device=x_uint8.device)
    if b == 0:
        return out
    from repro_torch.kernels.fused_mlp import build

    lib = build.load()
    device, stream = stream_args(x_uint8)
    err = lib.fmlp_predict(
        x_uint8.data_ptr(), b, k, int(threshold), w1.data_ptr(), h,
        w2.data_ptr(), o, out.data_ptr(), bm, device, stream)
    check_launch(err, lib.fmlp_error_string, name)
    fused_mlp_predict.launches += 1
    return out


reset_launches()
