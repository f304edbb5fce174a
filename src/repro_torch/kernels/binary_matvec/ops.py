"""Public ops of the binary matmul datapaths: kernel wrappers and bit packers.

Counterpart of `repro/kernels/binary_matvec/ops.py`. Each kernel wrapper
takes its plain version (`ref.py`) when its tensors lie on the CPU, and
launches its CUDA kernel (`csrc/binary_matvec.cu`, built on first use by
`build.py`) when they lie on a CUDA device. There is no fallback: a
failed build or launch raises. Each wrapper counts its kernel launches
in a plain integer attribute, `<wrapper>.launches`, that
`reset_launches()` sets back to 0.

`binary_matmul` and `binary_matmul_packed` have two CUDA routes, picked
by the weights' dtype alone (no device sync, no range check): int8
weights go to the int8 tensor-core kernel, int32 weights to the scalar
kernel, the route for weights that do not fit int8. `.launches` counts
both routes; `.mma_launches` counts the tensor-core launches alone.
`binary_matmul_planes` has one route, the 1-bit tensor cores, for any
plane count: planes are bits whatever the weights.

Packed words are int32 tensors holding the uint32 bit pattern (see
`ref.py`); numpy uint32 arrays cross over with `.view(np.int32)`.
`pack_bits`, `binarize_pack` and `step_pack` stay PyTorch tensor ops on
either device, as their JAX counterparts are `jnp` outside Pallas.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binary_matvec import ref
from repro_torch.kernels.launch import (
    BLOCK_ROWS, SMEM_LIMIT, check_block_rows, check_contiguous, check_launch,
    check_weights, placement, stream_args,
)

__all__ = [
    "BLOCK_ROWS", "ForwardTable", "binarize_pack", "binary_forward_planes",
    "binary_matmul", "binary_matmul_packed", "binary_matmul_planes",
    "check_forward_planes", "check_matmul_blocks", "forward_smem_bytes",
    "in_mma_layout", "mma_weights", "pack_bits", "plane_mma_weights", "planes_smem_bytes",
    "reset_launches", "step_pack",
]

MATMUL_BM, MATMUL_BN = 32, 32          # planes defaults (1-bit tensor cores): 128 blocks at layer 1
DENSE_BM, DENSE_BN = 4, 128            # dense defaults: 256 blocks at layer 1
PACKED_BM, PACKED_BN = 8, 64           # packed defaults: 256 blocks at layer 1
MMA_BM, MMA_BN = 32, 32                # tensor-core defaults: 128 blocks at layer 1
FORWARD_BM = 8
FORWARD_WARPS = 8                       # kForwardThreads / 32

binarize_pack = ref.binarize_pack
pack_bits = ref.pack_bits
step_pack = ref.step_pack


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    binary_matmul.launches = 0
    binary_matmul.mma_launches = 0
    binary_matmul_packed.launches = 0
    binary_matmul_packed.mma_launches = 0
    binary_matmul_planes.launches = 0
    binary_forward_planes.launches = 0


def check_matmul_blocks(bm: int | None = None, bn: int | None = None, *,
                        defaults: tuple[int, int] = (MATMUL_BM, MATMUL_BN)
                        ) -> tuple[int, int]:
    """(bm, bn) for a per-layer kernel, `defaults` filled in (the planes
    kernel's unless given); raises ValueError for a block shape the
    kernels are not built for."""
    name = "binary matmul"
    bm = check_block_rows(name, defaults[0] if bm is None else bm)
    bn = defaults[1] if bn is None else int(bn)
    if bn <= 0 or bn % 32 or bn > 1024:
        raise ValueError(f"{name}: bn={bn} must be a multiple of 32 <= 1024")
    return bm, bn


def mma_weights(w: torch.Tensor) -> torch.Tensor:
    """int8 weights (..., K, N) in the layout the tensor-core kernels read:
    the same (K, N) values, K contiguous within each column, every column
    starting on a 16-byte boundary. It is a transposed view of a
    zero-padded (..., N, ceil(K / 16) * 16) buffer, so it still has the
    public (K, N) shape. The netgen backend makes it once, when it builds a
    predictor; `binary_matmul` and `binary_matmul_packed` copy int8
    weights in any other layout into it on every call."""
    if w.dtype != torch.int8:
        raise TypeError(f"mma_weights: want int8 weights, got {w.dtype}")
    k, n = w.shape[-2:]
    buf = torch.zeros((*w.shape[:-2], n, -(-k // 16) * 16), dtype=torch.int8,
                      device=w.device)
    buf[..., :k] = w.transpose(-1, -2)
    return buf.transpose(-1, -2)[..., :k, :]


def plane_mma_weights(planes: torch.Tensor) -> torch.Tensor:
    """int32 plane words (..., P, KW, N) in the layout the 1-bit
    tensor-core kernel reads: the same words, KW contiguous within each
    column, every column starting on a 32-byte boundary. It is a
    transposed view of a zero-padded (..., P, N, ceil(KW / 8) * 8) buffer,
    so it still has the public (..., P, KW, N) shape. The netgen backend
    makes it once, when it builds a predictor; `binary_matmul_planes`
    copies planes in any other layout into it on every call."""
    if planes.dtype != torch.int32 or planes.dim() < 3:
        raise TypeError(f"plane_mma_weights: want int32 words (..., P, KW, N), got "
                        f"{planes.dtype} {tuple(planes.shape)}")
    kw, n = planes.shape[-2:]
    buf = torch.zeros((*planes.shape[:-2], n, -(-kw // 8) * 8), dtype=torch.int32,
                      device=planes.device)
    buf[..., :kw] = planes.transpose(-1, -2)
    return buf.transpose(-1, -2)[..., :kw, :]


def _in_plane_layout(p: torch.Tensor) -> bool:
    """(P, KW, N) words K-contiguous per column, with plane and column
    strides and the base 16-byte aligned, as the kernel reads them."""
    return p.stride(1) == 1 and p.stride(2) % 4 == 0 and p.stride(2) >= p.shape[1] \
        and p.stride(0) % 4 == 0 and p.data_ptr() % 16 == 0


def planes_smem_bytes(bm: int, p: int) -> int:
    """Dynamic shared memory of one planes block (`planes_smem` in the
    .cu source): two ring slots of 16 or 32 rows of x and 2P x 32 columns
    of planes, 8 words of K each in rows of 12 words."""
    tm = 32 if bm > 16 else 16
    return 2 * (tm + 2 * p * 32) * 12 * 4


def in_mma_layout(w: torch.Tensor) -> bool:
    """int8 (K, N) weights as the tensor-core kernels read them: K
    contiguous in each column, column stride and base 16-byte aligned."""
    return w.shape[0] == 0 or (w.stride(0) == 1 and w.stride(1) % 16 == 0
                               and w.stride(1) >= w.shape[0] and w.data_ptr() % 16 == 0)


def _route_blocks(w: torch.Tensor, bm, bn, scalar: tuple[int, int]):
    """(tensor-core route?, checked (bm, bn)) for weights w: int8 takes the
    tensor cores with the MMA defaults, int32 the scalar kernel with
    `scalar` defaults. On the tensor-core route bm maps to a tile of 16
    rows (bm <= 16) or 32 (bm = 32), and the block walks its bn columns
    32 at a time, so every (bm, bn) either route accepts is taken."""
    mma = w.dtype == torch.int8
    return mma, check_matmul_blocks(bm, bn, defaults=(MMA_BM, MMA_BN) if mma else scalar)


def _launch_matmul(name: str, x: torch.Tensor, w: torch.Tensor, k: int,
                   mma: bool, blocks: tuple[int, int]) -> torch.Tensor:
    """Launch the dense or packed kernel of one route: x (B, k), w (K, N)
    -> (B, N). The tensor-core route reads int8 w in the `mma_weights`
    layout, copying it there first when it is laid out otherwise."""
    bm, bn = blocks
    if mma and not in_mma_layout(w):
        w = mma_weights(w)
    entry = f"bmv_{name}_mma" if mma else f"bmv_{name}"
    check_contiguous(entry, (x,) if mma else (x, w))
    b, n = x.shape[0], w.shape[1]
    out = torch.empty((b, n), dtype=torch.int32, device=x.device)
    if b == 0 or n == 0:
        return out
    from repro_torch.kernels.binary_matvec import build

    lib = build.load()
    device, stream = stream_args(x)
    head = (x.data_ptr(), w.data_ptr()) + ((w.stride(1),) if mma else ())
    err = getattr(lib, entry)(*head, out.data_ptr(), b, k, n, bm, bn, device, stream)
    check_launch(err, lib.bmv_error_string, entry)
    return out


def binary_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int | None = None,
                  bn: int | None = None) -> torch.Tensor:
    """y = x @ w for x in {0, 1}: the rows of w selected by `x != 0`
    added up.

    x: int8 (B, K); w: int8 (K, N), the tensor-core route (fastest in the
    `mma_weights` layout), or int32, the scalar route. Returns int32
    (B, N), wrapping on overflow. `bm` is the rows per block (one of
    BLOCK_ROWS), `bn` the columns per block (a multiple of 32, at most
    1024); both only shape the CUDA launch.
    """
    name = "binary_matmul"
    check_weights(name, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: want x (B, K), w (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.int8:
        raise TypeError(f"{name}: activations must be int8, got {x.dtype}")
    mma, blocks = _route_blocks(w, bm, bn, (DENSE_BM, DENSE_BN))
    if placement(name, (x, w)) == "cpu":
        return ref.binary_matmul(x, w)
    out = _launch_matmul("matmul", x, w, x.shape[1], mma, blocks)
    binary_matmul.launches += 1
    binary_matmul.mma_launches += int(mma)
    return out


def binary_matmul_packed(xp: torch.Tensor, w: torch.Tensor, *,
                         bm: int | None = None,
                         bn: int | None = None) -> torch.Tensor:
    """y = unpack(xp) @ w: bit i of word c selects row 32c + i of w.

    xp: int32 words (B, KW); w: int8 (KW * 32, N), the tensor-core route,
    or int32, the scalar route. Returns int32 (B, N). `bm`/`bn` as in
    `binary_matmul`.
    """
    name = "binary_matmul_packed"
    check_weights(name, w)
    if xp.dim() != 2 or w.dim() != 2 or xp.shape[1] * ref.LANES != w.shape[0]:
        raise ValueError(f"{name}: want x (B, KW), w (KW * 32, N); got "
                         f"{tuple(xp.shape)}, {tuple(w.shape)}")
    if xp.dtype != torch.int32:
        raise TypeError(f"{name}: packed words must be int32 tensors")
    mma, blocks = _route_blocks(w, bm, bn, (PACKED_BM, PACKED_BN))
    if placement(name, (xp, w)) == "cpu":
        return ref.binary_matmul_packed(xp, w)
    out = _launch_matmul("matmul_packed", xp, w, xp.shape[1], mma, blocks)
    binary_matmul_packed.launches += 1
    binary_matmul_packed.mma_launches += int(mma)
    return out


def binary_matmul_planes(xp: torch.Tensor, pos: torch.Tensor,
                         neg: torch.Tensor, *, bm: int | None = None,
                         bn: int | None = None) -> torch.Tensor:
    """y = unpack(xp) @ w for w = sum_b 2^b (unpack(pos_b) - unpack(neg_b)).

    xp: int32 words (B, KW); pos/neg: int32 words (P, KW, N), fastest in
    the `plane_mma_weights` layout (any other layout is copied into it on
    each call). Returns int32 (B, N), wrapping on overflow. `bm` is the
    rows per block (one of BLOCK_ROWS; the tensor-core tile takes 16 rows
    for bm <= 16, else 32), `bn` the columns per block (a multiple of 32,
    at most 1024, walked 32 at a time); both only shape the CUDA launch.
    """
    name = "binary_matmul_planes"
    if xp.dim() != 2 or pos.dim() != 3 or pos.shape != neg.shape \
            or xp.shape[1] != pos.shape[1]:
        raise ValueError(
            f"{name}: want x (B, KW), pos/neg (P, KW, N); got "
            f"{tuple(xp.shape)}, {tuple(pos.shape)}, {tuple(neg.shape)}")
    if any(t.dtype != torch.int32 for t in (xp, pos, neg)):
        raise TypeError(f"{name}: packed words must be int32 tensors")
    if placement(name, (xp, pos, neg)) == "cpu":
        return ref.plane_matmul(xp, pos, neg)
    bm, bn = check_matmul_blocks(bm, bn)
    b, kw = xp.shape
    p, _, n = pos.shape
    smem = planes_smem_bytes(bm, p)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {p} planes need {smem} B of shared memory "
                         f"(limit {SMEM_LIMIT} B)")
    check_contiguous(name, (xp,))
    if not (_in_plane_layout(pos) and _in_plane_layout(neg)
            and pos.stride() == neg.stride()):
        pos, neg = plane_mma_weights(pos), plane_mma_weights(neg)
    out = torch.empty((b, n), dtype=torch.int32, device=xp.device)
    if b == 0 or n == 0:
        return out
    from repro_torch.kernels.binary_matvec import build

    lib = build.load()
    device, stream = stream_args(xp)
    err = lib.bmv_matmul_planes(
        xp.data_ptr(), pos.data_ptr(), neg.data_ptr(), pos.stride(0), pos.stride(2),
        out.data_ptr(), b, kw, p, n, bm, bn, device, stream)
    check_launch(err, lib.bmv_error_string, name)
    binary_matmul_planes.launches += 1
    return out


def forward_smem_bytes(layer_words, bm: int) -> int:
    """Dynamic shared memory of one forward block: two activation buffers
    of bm x max(words) words and the per-warp argmax partials."""
    return 4 * (2 * bm * max(layer_words) + 2 * FORWARD_WARPS * bm)


def check_forward_planes(layer_words, bm: int | None = None) -> int:
    """Raise ValueError when the forward kernel cannot take a net with
    these per-layer word widths at `bm` rows per block; returns bm.
    Checked on every device, so a net the kernel refuses is refused on
    the CPU too. Any depth is taken: the layer table lies in device
    memory (`ForwardTable`)."""
    name = "binary_forward_planes"
    bm = check_block_rows(name, FORWARD_BM if bm is None else bm)
    if not layer_words:
        raise ValueError(f"{name}: want at least one layer")
    smem = forward_smem_bytes(layer_words, bm)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: {smem} B of shared memory at bm={bm} exceeds "
            f"{SMEM_LIMIT} B (widest layer {max(layer_words)} words)")
    return bm


class ForwardTable:
    """The forward kernel's layer table for one set of plane tensors: per
    layer, a 32-byte row (pos and neg pointers; P, W, N; padding; the
    `PlaneLayer` struct of the .cu source) in an int64 (depth, 4) tensor
    on the planes' device. It is a pure function of the tensors' addresses
    and shapes (`key`), so a table built once, when a predictor is built,
    serves every call on those tensors without a host-to-device copy."""

    def __init__(self, planes):
        pairs = list(zip(planes[0::2], planes[1::2]))
        self.key = _table_key(planes)
        rows = [[p.data_ptr(), q.data_ptr(), p.shape[-3] | (p.shape[-2] << 32),
                 p.shape[-1]] for p, q in pairs]
        self.rows = torch.tensor(rows, dtype=torch.int64).to(planes[0].device)


def _table_key(planes) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape)) for t in planes)


def binary_forward_planes(x: torch.Tensor, *planes: torch.Tensor,
                          threshold: int, n_classes: int,
                          bm: int | None = None,
                          table: ForwardTable | None = None) -> torch.Tensor:
    """Whole-net forward in one launch: raw uint8 images -> class ids.

    x: uint8 (B, K), or (M, B, K) for a stacked M-model plan. `planes`
    interleaves pos_0, neg_0, pos_1, neg_1, ... int32 words
    (P_l, W_l, N_l) per layer ((M, P_l, W_l, N_l) when stacked), as
    `ExecutionPlan.megakernel_view()` lays them out: each hidden N_l ==
    W_{l+1} * 32. Returns int32 (B,) / (M, B). `bm` is the rows per
    block of the CUDA launch. `table` is the `ForwardTable` of `planes`,
    made once by a caller that calls again on the same tensors; without
    it the CUDA route builds one per call (a host-to-device copy).
    """
    name = "binary_forward_planes"
    if not planes or len(planes) % 2:
        raise ValueError(f"{name}: want pos/neg pairs, got {len(planes)}")
    if x.dtype != torch.uint8 or x.dim() not in (2, 3):
        raise ValueError(f"{name}: want uint8 (B, K) or (M, B, K) images")
    stacked = x.dim() == 3
    pairs = list(zip(planes[0::2], planes[1::2]))
    for li, (pos, neg) in enumerate(pairs):
        if pos.shape != neg.shape or pos.dim() != (4 if stacked else 3):
            raise ValueError(f"{name}: layer {li} planes {tuple(pos.shape)}, "
                             f"{tuple(neg.shape)}")
        if pos.dtype != torch.int32 or neg.dtype != torch.int32:
            raise TypeError(f"{name}: packed words must be int32 tensors")
        if stacked and pos.shape[0] != x.shape[0]:
            raise ValueError(f"{name}: layer {li} has {pos.shape[0]} models, "
                             f"images {x.shape[0]}")
        if li + 1 < len(pairs):
            if pos.shape[-1] != pairs[li + 1][0].shape[-2] * ref.LANES:
                raise ValueError(
                    f"{name}: layer {li} fan_out {pos.shape[-1]} != 32 x "
                    f"next words {pairs[li + 1][0].shape[-2]}")
        elif not 1 <= n_classes <= pos.shape[-1]:
            raise ValueError(f"{name}: n_classes {n_classes} outside "
                             f"[1, {pos.shape[-1]}]")
    k = x.shape[-1]
    if pairs[0][0].shape[-2] * ref.LANES < k:
        raise ValueError(f"{name}: {k} inputs exceed layer 0's "
                         f"{pairs[0][0].shape[-2]} words")
    layer_words = [p.shape[-2] for p, _ in pairs]
    bm = check_forward_planes(layer_words, bm)
    if placement(name, (x, *planes)) == "cpu":
        return ref.forward_planes(x, *planes, threshold=threshold,
                                  n_classes=n_classes)
    check_contiguous(name, (x, *planes))
    m = x.shape[0] if stacked else 1
    b = x.shape[-2]
    out = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
    if b == 0 or m == 0:
        return out
    from repro_torch.kernels.binary_matvec import build

    lib = build.load()
    if table is None:
        table = ForwardTable(planes)
    elif table.key != _table_key(planes) or table.rows.device != x.device:
        raise ValueError(f"{name}: the layer table was built for other tensors")
    device, stream = stream_args(x)
    err = lib.bmv_forward_planes(
        x.data_ptr(), m, b, k, int(threshold), table.rows.data_ptr(), len(pairs),
        max(layer_words), int(n_classes), out.data_ptr(), bm, device, stream)
    check_launch(err, lib.bmv_error_string, name)
    binary_forward_planes.launches += 1
    return out


reset_launches()
