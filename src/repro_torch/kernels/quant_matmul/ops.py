"""Public ops of the W8A8 quantized matmul kernel.

Counterpart of `repro/kernels/quant_matmul/ops.py`. `quant_matmul` takes
its plain version (`ref.py`) when its tensors lie on the CPU, and
launches the CUDA kernel (`csrc/quant_matmul.cu`, `wgmma` fed by TMA,
built on first use by `build.py`) when they lie on a CUDA device; a
failed build or launch raises. The kernel reads w_q K-major: the
`qmm_weights` view is taken as it is, any other layout is copied into it
on each call. Two tiles, chosen from M: 64 x 64 for M <= NARROW_M (a
decode step), 128 x 128 above. `qlinear` quantizes the activation per
tensor, runs the int8 product against pre-quantized weights and returns
x's dtype. Launches are counted in `quant_matmul.launches`, those of the
narrow tile also in `quant_matmul.narrow_launches`; `reset_launches()`
sets both back to 0.

On `meta` tensors `quant_matmul` returns its fake, an empty fp32 (M, N).
Under the counting mode (`launch/cost.py`) each call records `work(M, K,
N)` once, whichever of the kernel, its plain version or its fake ran.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.launch import check_contiguous, check_launch, placement, stream_args
from repro_torch.kernels.quant_matmul import ref

__all__ = ["NARROW_M", "qmm_weights", "quant_matmul", "quantize_act", "quantize_weight",
           "qlinear", "reset_launches", "work"]

NARROW_M = 64           # largest M that takes the 64 x 64 tile


def reset_launches() -> None:
    """Set the wrapper's launch counts to 0."""
    quant_matmul.launches = 0
    quant_matmul.narrow_launches = 0


def _k_pad(k: int) -> int:
    """Row length in bytes the kernel's TMA reads: K rounded up to 16, at
    least 16 (TMA wants 16-byte row strides; the zero padding is exact)."""
    return max(16, -(-k // 16) * 16)


def qmm_weights(w_q: torch.Tensor) -> torch.Tensor:
    """int8 weights (K, N) in the layout the kernel reads: the same
    values, K contiguous within each column, columns 16-byte aligned. It
    is a transposed view of a zero-padded (N, ceil(K / 16) * 16) buffer,
    so it keeps the public (K, N) shape. Make it once and hand it to
    `quant_matmul`/`qlinear`; a row-major w_q is copied into it on every
    call."""
    if w_q.dtype != torch.int8 or w_q.dim() != 2:
        raise TypeError(f"qmm_weights: want int8 (K, N), got {w_q.dtype} {tuple(w_q.shape)}")
    k, n = w_q.shape
    buf = torch.zeros((n, _k_pad(k)), dtype=torch.int8, device=w_q.device)
    buf[:, :k] = w_q.T
    return buf.T[:k]


def _in_qmm_layout(w: torch.Tensor) -> bool:
    return w.stride(0) == 1 and w.stride(1) % 16 == 0 and w.stride(1) >= _k_pad(w.shape[0]) \
        and w.data_ptr() % 16 == 0


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx, sw: torch.Tensor
                 ) -> torch.Tensor:
    """y = (x_q @ w_q) * sx * sw. x_q int8 (M, K), contiguous; w_q int8
    (K, N), fastest as `qmm_weights(w_q)`; sx an fp32 scalar (a
    one-element tensor on the operands' device, or a number); sw fp32
    (N,). Returns fp32 (M, N)."""
    name = "quant_matmul"
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0] \
            or sw.shape != (w_q.shape[1],):
        raise ValueError(f"{name}: want x_q (M, K), w_q (K, N), sw (N,); got "
                         f"{tuple(x_q.shape)}, {tuple(w_q.shape)}, {tuple(sw.shape)}")
    if not isinstance(sx, torch.Tensor):
        sx = torch.tensor(sx, dtype=torch.float32, device=x_q.device)
    if sx.numel() != 1:
        raise ValueError(f"{name}: sx must be one scale, got shape {tuple(sx.shape)}")
    kind = placement(name, (x_q, w_q, sx, sw), fake=True)
    with _counted(*x_q.shape, w_q.shape[1]):
        if kind == "cpu":
            return ref.quant_matmul_ref(x_q, w_q, sx.reshape(()), sw)
        if kind == "meta":
            return torch.empty((x_q.shape[0], w_q.shape[1]), dtype=torch.float32,
                               device="meta")
        return _launch(name, x_q, w_q, sx, sw)


def work(m: int, k: int, n: int) -> tuple[int, int]:
    """(operations, bytes) of one (m, k) x (k, n) call: 2mkn integer
    multiply-adds and the epilogue's two multiplies per output; int8 x
    and w, the fp32 scales and the fp32 output."""
    return 2 * m * k * n + 2 * m * n, m * k + k * n + 4 * (n + 1) + 4 * m * n


def _counted(m, k, n):
    from repro_torch.launch import cost
    if not cost.active():
        return contextlib.nullcontext()
    ops, bytes_ = work(m, k, n)
    return cost.kernel("quant_matmul", flops=ops, bytes_=bytes_)


def _launch(name, x_q, w_q, sx, sw):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"{name}: x_q and w_q must be int8, got {x_q.dtype}, {w_q.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"{name}: sx and sw must be float32, got {sx.dtype}, {sw.dtype}")
    check_contiguous(name, (x_q, sw))
    (m, k), n = x_q.shape, w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    if not _in_qmm_layout(w_q):
        w_q = qmm_weights(w_q)
    if k % 16 or k == 0 or x_q.data_ptr() % 16:
        x_q = torch.nn.functional.pad(x_q, (0, _k_pad(k) - k))
    from repro_torch.kernels.quant_matmul import build

    narrow = m <= NARROW_M
    lib = build.load()
    device, stream = stream_args(x_q)
    err = lib.qmm_matmul(x_q.data_ptr(), x_q.stride(0), w_q.data_ptr(), w_q.stride(1),
                         sx.reshape(1).data_ptr(), sw.data_ptr(), out.data_ptr(), m, n, k,
                         int(narrow), device, stream)
    check_launch(err, lib.qmm_error_string, name)
    quant_matmul.launches += 1
    quant_matmul.narrow_launches += int(narrow)
    return out


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.quantize_act_ref(x)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.quantize_weight_ref(w)


def qlinear(x: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """fp activation in, fp out; weights already int8 + per-channel scales
    (w_q fastest as `qmm_weights(w_q)`, made once)."""
    x_q, sx = ref.quantize_act_ref(x)
    return quant_matmul(x_q, w_q, sx, sw).to(x.dtype)


reset_launches()
