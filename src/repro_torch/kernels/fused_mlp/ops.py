"""Public op of the fused two-layer kernel.

Counterpart of `repro/kernels/fused_mlp/ops.py`. The wrapper takes its
plain version (`ref.py`) when its tensors lie on the CPU, and launches
a CUDA kernel (`csrc/fused_mlp.cu`, built on first use by `build.py`)
when they lie on a CUDA device; a failed build or launch raises.

Two CUDA routes, picked by the weights' dtype alone, as `binary_matmul`
picks them: int8 w1 and w2 go to the int8 tensor-core kernel (16 rows a
block, the hidden units split across a cluster of 8 blocks; w1 fastest
in the `mma_weights` layout, w2 with its H axis contiguous, each copied
there per call otherwise); int32 weights, or a mix, to the scalar
kernel (`bm` rows a block). `fused_mlp_predict.launches` counts both
routes and `.mma_launches` the tensor-core launches alone;
`reset_launches()` sets both back to 0. A shape whose activations the
route's shared memory cannot hold is refused on every device, so the
CPU refuses what the card would.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binary_matvec.ops import in_mma_layout, mma_weights
from repro_torch.kernels.fused_mlp import ref
from repro_torch.kernels.launch import (
    SMEM_LIMIT, check_block_rows, check_contiguous, check_launch, check_weights,
    placement, stream_args,
)

__all__ = ["FUSED_BM", "check_fused", "fused_mlp_predict", "fused_mma_smem_bytes",
           "fused_smem_bytes", "reset_launches"]

FUSED_BM = 2                # default rows per block of the scalar route
_LANES = 32
# The tensor-core route (`fused_mma_kernel`): rows a block, blocks a
# cluster, hidden units a sub-tile, and the staged ring (4 slots of
# 16 + 64 rows of 272 bytes).
_MMA_ROWS, _MMA_CLUSTER, _MMA_SUBN, _MMA_RING = 16, 8, 64, 4 * (16 + 64) * 272


def reset_launches() -> None:
    """Set the wrapper's launch counts to 0."""
    fused_mlp_predict.launches = 0
    fused_mlp_predict.mma_launches = 0


def fused_smem_bytes(k: int, h: int, o: int, bm: int) -> int:
    """Dynamic shared memory of one scalar block: the tile's packed inputs
    and hidden activations, and its (bm, o) class scores."""
    return 4 * bm * (-(-k // _LANES) + -(-h // _LANES) + o)


def fused_mma_smem_bytes(h: int, o: int) -> int:
    """Dynamic shared memory of one tensor-core block (`mma_smem` in the
    .cu source): the cp.async ring, the block's slice of hidden units as
    bytes for 16 rows and of w2 for o classes, and its (16, o) partial
    class scores."""
    per_block = -(-h // _MMA_CLUSTER)
    unit_slice = -(-per_block // _MMA_SUBN) * _MMA_SUBN
    return _MMA_RING + (_MMA_ROWS + o) * unit_slice + 4 * _MMA_ROWS * o


def check_fused(k: int, h: int, o: int, bm: int | None = None, *,
                mma: bool = False) -> int:
    """Raise ValueError when the kernel of a route (`mma`: the tensor-core
    route) cannot take a K-H-O net at `bm` rows per block; returns bm
    (the default filled in; the tensor-core route takes 16 rows a block
    whatever bm)."""
    name = "fused_mlp_predict"
    bm = check_block_rows(name, FUSED_BM if bm is None else bm)
    if o < 1:
        raise ValueError(f"{name}: want at least one class, got {o}")
    smem = fused_mma_smem_bytes(h, o) if mma else fused_smem_bytes(k, h, o, bm)
    if smem > SMEM_LIMIT:
        route = "the tensor-core route" if mma else f"bm={bm}"
        raise ValueError(f"{name}: {smem} B of shared memory at {route} "
                         f"exceeds {SMEM_LIMIT} B ({k}-{h}-{o} net)")
    return bm


def fused_mlp_predict(x_uint8: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor, *, threshold: int,
                      bm: int | None = None) -> torch.Tensor:
    """Predictions for a batch, the whole 2-layer net in one launch.

    x_uint8: uint8 (B, K); w1: (K, H) and w2: (H, O), both int8 (the
    tensor-core route) or int32 (the scalar route; int8 beside int32 is
    cast to int32). Binarize `x > threshold`, layer 1, strict step, layer
    2, argmax (the first maximum wins). Returns int32 (B,). `bm` is the
    rows per block of the scalar launch (one of BLOCK_ROWS).
    """
    name = "fused_mlp_predict"
    if x_uint8.dtype != torch.uint8 or x_uint8.dim() != 2:
        raise ValueError(f"{name}: want uint8 (B, K) images")
    check_weights(name, w1)
    check_weights(name, w2)
    mma = w1.dtype == w2.dtype == torch.int8
    if not mma:
        w1, w2 = w1.to(torch.int32), w2.to(torch.int32)
    if w1.dim() != 2 or w2.dim() != 2 or x_uint8.shape[1] != w1.shape[0] \
            or w1.shape[1] != w2.shape[0]:
        raise ValueError(
            f"{name}: want x (B, K), w1 (K, H), w2 (H, O); got "
            f"{tuple(x_uint8.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    (b, k), (h, o) = x_uint8.shape, w2.shape
    bm = check_fused(k, h, o, bm, mma=mma)
    if placement(name, (x_uint8, w1, w2)) == "cpu":
        return ref.fused_mlp_predict(x_uint8, w1, w2, threshold=threshold)
    if mma:
        if not in_mma_layout(w1):
            w1 = mma_weights(w1)
        if h > 1 and w2.stride(0) != 1:
            w2 = mma_weights(w2)
        check_contiguous(name, (x_uint8,))
    else:
        check_contiguous(name, (x_uint8, w1, w2))
    out = torch.empty((b,), dtype=torch.int32, device=x_uint8.device)
    if b == 0:
        return out
    from repro_torch.kernels.fused_mlp import build

    lib = build.load()
    device, stream = stream_args(x_uint8)
    if mma:
        err = lib.fmlp_predict_mma(
            x_uint8.data_ptr(), b, k, int(threshold), w1.data_ptr(), w1.stride(1), h,
            w2.data_ptr(), w2.stride(1), o, out.data_ptr(), device, stream)
    else:
        err = lib.fmlp_predict(
            x_uint8.data_ptr(), b, k, int(threshold), w1.data_ptr(), h,
            w2.data_ptr(), o, out.data_ptr(), bm, device, stream)
    check_launch(err, lib.fmlp_error_string, name)
    fused_mlp_predict.launches += 1
    fused_mlp_predict.mma_launches += int(mma)
    return out


reset_launches()
