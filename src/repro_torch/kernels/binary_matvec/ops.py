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
`binary_forward_planes` has two, picked by shapes alone: the 1-bit
tensor-core kernel, whose blocks of a cluster split each hidden layer's
units, for every net whose activations fit its shared memory
(`forward_on_mma`), and the scalar kernel for the rest; `.launches`
counts both, `.mma_launches` the tensor-core launches.

Packed words are int32 tensors holding the uint32 bit pattern (see
`ref.py`); numpy uint32 arrays cross over with `.view(np.int32)`.
`pack_bits`, `binarize_pack` and `step_pack` stay PyTorch tensor ops on
either device, as their JAX counterparts are `jnp` outside Pallas.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.binary_matvec import ref
from repro_torch.kernels.launch import (
    BLOCK_ROWS, SMEM_LIMIT, check_block_rows, check_contiguous, check_launch,
    check_weights, placement, stream_args,
)

__all__ = [
    "BLOCK_ROWS", "FORWARD_CLUSTERS", "ForwardTable", "binarize_pack",
    "binary_forward_planes", "binary_matmul", "binary_matmul_packed",
    "binary_matmul_planes", "check_forward_planes", "check_matmul_blocks",
    "forward_cluster", "forward_mma_smem_bytes", "forward_on_mma", "forward_smem_bytes",
    "forward_stage_words", "launch_cluster",
    "in_mma_layout", "mma_weights", "pack_bits", "plane_mma_weights", "planes_smem_bytes",
    "reset_launches", "step_pack",
]

MATMUL_BM, MATMUL_BN = 32, 32          # planes defaults (1-bit tensor cores): 128 blocks at layer 1
DENSE_BM, DENSE_BN = 4, 128            # dense defaults: 256 blocks at layer 1
PACKED_BM, PACKED_BN = 8, 64           # packed defaults: 256 blocks at layer 1
MMA_BM, MMA_BN = 32, 32                # tensor-core defaults: 128 blocks at layer 1
FORWARD_BM = 8
FORWARD_WARPS = 8                       # kForwardThreads / 32
FORWARD_MMA_WARPS = 4                   # kFwdThreads / 32
FORWARD_CLUSTERS = (1, 2, 4, 8)         # blocks a tensor-core forward cluster may have

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
    binary_forward_planes.mma_launches = 0


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


def _staged_words(words: int) -> int:
    """An activation row of `words` words (`forward_mma_ldx`): rounded up
    to 8, then to 8 mod 16."""
    ldx = -(-words // 8) * 8
    return ldx if ldx % 16 else ldx + 8


def forward_stage_words(layer_planes, layer_words) -> int:
    """Words of one stage slot of the tensor-core forward kernel: the
    largest layer's 2P plane columns, W rounded up to 8 words, for one
    stage of 32 columns (`bmv_forward_stage_words`)."""
    return max(2 * p * 32 * -(-w // 8) * 8 for p, w in zip(layer_planes, layer_words))


def forward_mma_smem_bytes(layer_planes, layer_words, bm: int) -> int:
    """Dynamic shared memory of one tensor-core forward block
    (`forward_mma_smem` in the .cu source): two activation buffers of 16
    rows (bm <= 16) or 32 at the widest layer's staged row, the per-warp
    argmax partials, two stage slots' mbarriers and the two slots."""
    tm = 32 if bm > 16 else 16
    return 4 * (2 * tm * _staged_words(max(layer_words)) + 2 * FORWARD_MMA_WARPS * tm + 4
                + 2 * forward_stage_words(layer_planes, layer_words))


def forward_on_mma(layer_planes, layer_words, bm: int | None = None) -> bool:
    """Whether `binary_forward_planes` takes the 1-bit tensor-core route
    for a net with these per-layer plane counts and word widths at `bm`
    rows per block: whenever its activations and two stages of planes fit
    the route's shared memory. Shapes alone decide, so the backend knows
    the route when it builds a predictor."""
    bm = FORWARD_BM if bm is None else bm
    return forward_mma_smem_bytes(layer_planes, layer_words, bm) <= SMEM_LIMIT


def forward_cluster(layer_words) -> int:
    """The most blocks a tensor-core forward cluster takes for a net: the
    largest of 1, 2, 4, 8 that does not exceed the widest hidden layer's
    output words (the words of layers 1..), so every block has units of
    it; 1 for a single-layer net."""
    widest = max(layer_words[1:], default=1)
    return max(c for c in FORWARD_CLUSTERS if c <= max(1, widest))


@functools.lru_cache(maxsize=None)
def _max_clusters(device: int, bm: int, cluster: int, smem: int) -> int:
    from repro_torch.kernels.binary_matvec import build

    lib = build.load()
    n = lib.bmv_forward_max_clusters(bm, cluster, smem, device)
    check_launch(-n if n < 0 else 0, lib.bmv_error_string, "bmv_forward_max_clusters")
    return n


def launch_cluster(layer_planes, layer_words, rows: int, models: int, bm: int,
                   device: torch.device) -> int:
    """The cluster size a tensor-core forward launch takes on `device`:
    the largest up to `forward_cluster` whose clusters (one per row tile
    and model) the card holds at once (`cudaOccupancyMaxActiveClusters`
    at the block's shared memory), so the grid runs in one wave; the
    largest allowed when none does. On an H100 at 784-500-10 it holds 45
    clusters of 8 blocks and 92 of 4, so 16 row tiles of one model take
    clusters of 8 and three models' 48 take clusters of 4."""
    tm = 32 if bm > 16 else 16
    tiles = models * -(-rows // tm)
    smem = forward_mma_smem_bytes(layer_planes, layer_words, bm)
    cap = forward_cluster(layer_words)
    index = device.index if device.index is not None else torch.cuda.current_device()
    for c in sorted(FORWARD_CLUSTERS, reverse=True):
        if c <= cap and tiles <= _max_clusters(index, bm, c, smem):
            return c
    return cap


def _in_forward_layout(p: torch.Tensor) -> bool:
    """(…, P, W, N) words as the tensor-core forward kernel reads them, the
    `plane_mma_weights` layout: K-contiguous per column at a column stride
    of W rounded up to 8, planes and models packed at P x N x stride (so
    a run of columns of one plane is contiguous), the base 16-byte
    aligned."""
    ldw, n, w = p.stride(-1), p.shape[-1], p.shape[-2]
    lead = p.dim() < 4 or p.stride(-4) == p.shape[-3] * n * ldw
    return p.stride(-2) == 1 and ldw == -(-w // 8) * 8 \
        and p.stride(-3) == n * ldw and lead and p.data_ptr() % 16 == 0


class ForwardTable:
    """The forward kernels' layer table for one set of plane tensors: per
    layer, a 32-byte row (pos and neg pointers; P, W, N; the column stride,
    which the tensor-core kernel reads; the `PlaneLayer` struct of the .cu
    source) in an int64 (depth, 4) tensor on the planes' device. It is a
    pure function of the tensors' addresses and shapes (`key`) and strides
    (`strides`), so a table built once, when a predictor is built, serves
    every call on those tensors without a host-to-device copy."""

    def __init__(self, planes):
        pairs = list(zip(planes[0::2], planes[1::2]))
        self.key = _table_key(planes)
        self.strides = tuple(t.stride() for t in planes)
        rows = [[p.data_ptr(), q.data_ptr(), p.shape[-3] | (p.shape[-2] << 32),
                 p.shape[-1] | (p.stride(-1) << 32)] for p, q in pairs]
        self.rows = torch.tensor(rows, dtype=torch.int64).to(planes[0].device)


def _table_key(planes) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape)) for t in planes)


def binary_forward_planes(x: torch.Tensor, *planes: torch.Tensor,
                          threshold: int, n_classes: int,
                          bm: int | None = None, cluster: int | None = None,
                          table: ForwardTable | None = None) -> torch.Tensor:
    """Whole-net forward in one launch: raw uint8 images -> class ids.

    x: uint8 (B, K), or (M, B, K) for a stacked M-model plan. `planes`
    interleaves pos_0, neg_0, pos_1, neg_1, ... int32 words
    (P_l, W_l, N_l) per layer ((M, P_l, W_l, N_l) when stacked), as
    `ExecutionPlan.megakernel_view()` lays them out: each hidden N_l ==
    W_{l+1} * 32. Returns int32 (B,) / (M, B).

    On CUDA tensors the route follows from the shapes (`forward_on_mma`):
    the 1-bit tensor-core route reads planes in the `plane_mma_weights`
    layout, the scalar route row-major; planes in the other layout are
    copied into the route's for the call (with a table of their own).
    `bm` is the rows per block (the tensor-core route takes a tile of 16
    rows for bm <= 16, else 32); `cluster` the blocks of a tensor-core
    cluster (one of FORWARD_CLUSTERS, default `launch_cluster`); both
    only shape the CUDA launch. `table` is the `ForwardTable` of
    `planes`, made once by a caller that calls again on the same tensors;
    without it the CUDA route builds one per call (a host-to-device copy).
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
    layer_planes = [p.shape[-3] for p, _ in pairs]
    bm = check_forward_planes(layer_words, bm)
    if cluster is not None and cluster not in FORWARD_CLUSTERS:
        raise ValueError(f"{name}: cluster={cluster} not in {FORWARD_CLUSTERS}")
    if placement(name, (x, *planes)) == "cpu":
        return ref.forward_planes(x, *planes, threshold=threshold,
                                  n_classes=n_classes)
    check_contiguous(name, (x,))
    if table is not None and (table.key != _table_key(planes)
                              or table.strides != tuple(t.stride() for t in planes)
                              or table.rows.device != x.device):
        raise ValueError(f"{name}: the layer table was built for other tensors")
    mma = forward_on_mma(layer_planes, layer_words, bm)
    if mma and not all(_in_forward_layout(p) and p.stride() == q.stride()
                       for p, q in pairs):
        planes, table = tuple(plane_mma_weights(p) for p in planes), None
    elif not mma and not all(p.is_contiguous() for p in planes):
        planes, table = tuple(p.contiguous() for p in planes), None
    m = x.shape[0] if stacked else 1
    b = x.shape[-2]
    out = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
    if b == 0 or m == 0:
        return out
    from repro_torch.kernels.binary_matvec import build

    lib = build.load()
    if table is None:
        table = ForwardTable(planes)
    device, stream = stream_args(x)
    head = (x.data_ptr(), m, b, k, int(threshold), table.rows.data_ptr(), len(pairs),
            max(layer_words), int(n_classes), out.data_ptr(), bm)
    if mma:
        if cluster is None:
            cluster = launch_cluster(layer_planes, layer_words, b, m, bm, x.device)
        err = lib.bmv_forward_planes_mma(
            *head, cluster, forward_stage_words(layer_planes, layer_words), device, stream)
    else:
        err = lib.bmv_forward_planes(*head, device, stream)
    check_launch(err, lib.bmv_error_string, name)
    binary_forward_planes.launches += 1
    binary_forward_planes.mma_launches += int(mma)
    return out


reset_launches()
