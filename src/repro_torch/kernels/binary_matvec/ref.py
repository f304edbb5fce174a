"""Plain PyTorch versions of the binary matmul kernels and the bit packers.

Counterpart of `repro/kernels/binary_matvec/ref.py`. Packed words travel
as int32 tensors holding the uint32 bit pattern: bit i of word j is
element 32*j + i (little-endian within the word). PyTorch has no
popcount and cannot shift uint32 on the CPU, so the bit arithmetic here
widens words to int64 (`_unsigned`) and narrows results back with the
same bit pattern (`_as_words`).

These functions run on any device. The wrappers in `ops.py` send CPU
tensors here; `chip_smoke.py` runs them on the card to check and to
time the CUDA kernels against.
"""
from __future__ import annotations

import torch

__all__ = [
    "LANES", "binarize_pack", "binary_matmul", "binary_matmul_packed",
    "forward_planes", "pack_bits", "pack_bool", "plane_matmul", "popcount",
    "step_pack", "unpack_bits",
]

LANES = 32          # activation bits per packed word
_MATMUL_CHUNK = 64  # rows of w per masked-sum step in `binary_matmul`


def _unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2**32) with the same bits."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _as_words(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wrap)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(LANES, dtype=torch.int64, device=device)


def pack_bool(bits: torch.Tensor, words: int) -> torch.Tensor:
    """Pack a boolean (..., n) into int32 words (..., words), zero-padding
    n up to words * 32."""
    n = bits.shape[-1]
    kp = words * LANES
    if kp < n:
        raise ValueError(f"{n} bits do not fit in {words} words")
    b = bits.to(torch.int64)
    if kp != n:
        b = torch.nn.functional.pad(b, (0, kp - n))
    b = b.reshape(*bits.shape[:-1], words, LANES)
    return _as_words((b << _shifts(bits.device)).sum(-1))


def binarize_pack(x_uint8: torch.Tensor, *, threshold: int,
                  words: int) -> torch.Tensor:
    """Raw uint8 pixels -> packed words of `pixel > threshold`."""
    return pack_bool(x_uint8.to(torch.int32) > threshold, words)


def step_pack(acc: torch.Tensor, *, words: int) -> torch.Tensor:
    """Strict step and repack: int32 accumulators (..., N) -> words of
    `acc > 0`."""
    return pack_bool(acc > 0, words)


def unpack_bits(xp: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of `pack_bool`: int32 words (..., KW) -> int8 bits (..., k)."""
    kw = xp.shape[-1]
    if kw * LANES < k:
        raise ValueError(f"{kw} words hold fewer than {k} bits")
    bits = (_unsigned(xp)[..., None] >> _shifts(xp.device)) & 1
    return bits.reshape(*xp.shape[:-1], kw * LANES)[..., :k].to(torch.int8)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack binary activations (B, K), any dtype with nonzero meaning 1,
    into int32 words (B, ceil(K / 32)), zero-padding K up to a multiple
    of 32."""
    return pack_bool(x != 0, -(-x.shape[-1] // LANES))


def binary_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The function of `binary_matmul`: int32 (B, N) = the sum of the rows
    of w (K, N) selected by `x != 0` for x (B, K), a masked column sum
    with no multiply. Sums in int64 and wraps to int32 like the kernel;
    K is swept in chunks so the (B, chunk, N) select stays small."""
    w = w.to(torch.int64)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64,
                      device=x.device)
    for k0 in range(0, x.shape[1], _MATMUL_CHUNK):
        k1 = k0 + _MATMUL_CHUNK
        acc += torch.where(x[:, k0:k1, None] != 0, w[None, k0:k1], 0).sum(1)
    return _as_words(acc)


def binary_matmul_packed(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The function of `binary_matmul_packed`: `binary_matmul` of the
    activations unpacked from int32 words xp (B, KW), w (KW * 32, N)."""
    return binary_matmul(unpack_bits(xp, w.shape[0]), w)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 word (as uint32), as int64."""
    v = _unsigned(words)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def plane_matmul(xp: torch.Tensor, pos: torch.Tensor,
                 neg: torch.Tensor) -> torch.Tensor:
    """The function of `binary_matmul_planes`: int32 (B, N) =
    sum_b 2^b (popc(x & pos_b) - popc(x & neg_b)) summed over the words,
    for x int32 words (B, KW) and pos/neg int32 words (P, KW, N). Wraps
    on int32 overflow like the kernels."""
    x = _unsigned(xp)[:, :, None]                      # (B, KW, 1)
    acc = torch.zeros((xp.shape[0], pos.shape[-1]), dtype=torch.int64,
                      device=xp.device)
    for b in range(pos.shape[0]):
        cp = popcount(x & _unsigned(pos[b])[None]).sum(1)
        cn = popcount(x & _unsigned(neg[b])[None]).sum(1)
        acc += (cp - cn) << b
    return _as_words(acc)


def forward_planes(x: torch.Tensor, *planes: torch.Tensor, threshold: int,
                   n_classes: int) -> torch.Tensor:
    """The function of `binary_forward_planes`: raw uint8 (B, K) or
    stacked (M, B, K) through interleaved pos/neg plane words
    (`ExecutionPlan.megakernel_view()` arrays) to int32 class ids (B,) /
    (M, B). Argmax over the first `n_classes` scores; the first maximum
    wins."""
    if x.dim() == 3:
        return torch.stack([
            forward_planes(x[m], *[p[m] for p in planes], threshold=threshold,
                           n_classes=n_classes)
            for m in range(x.shape[0])])
    a = binarize_pack(x, threshold=threshold, words=planes[0].shape[-2])
    depth = len(planes) // 2
    for li in range(depth):
        acc = plane_matmul(a, planes[2 * li], planes[2 * li + 1])
        if li + 1 < depth:
            a = step_pack(acc, words=planes[2 * li + 2].shape[-2])
    return torch.argmax(acc[:, :n_classes], dim=-1).to(torch.int32)
