"""Public op of the Mamba2 SSD scan kernel.

Counterpart of `repro/kernels/ssd_scan/ops.py`, with the same layout and
contract: `ssd(x, dt, a_per_head, b, c, chunk=)` on the model layout
(batch, length, heads, ...), `L % chunk == 0`. The wrapper takes its
plain version (`ref.ssd`) when its tensors lie on the CPU, and launches
the CUDA kernel (`csrc/ssd_scan.cu`, built on first use by `build.py`)
when they lie on a CUDA device; a failed build or launch raises.

Unlike the JAX op, the kernel reads the model layout in place: it takes
the batch and length strides of x, dt, b and c, maps head h to group
h // (H/G) itself, and never materializes B and C repeated over the
heads. The innermost two dims of x, b and c, and the head dim of dt,
must be packed (stride 1 and the inner size).

Two CUDA routes, picked by dtype and shape: bf16 inputs whose chunk is a
multiple of 16 up to 128, with N <= 128 and P <= 64 (mamba2-2.7b's
layers), go to the tensor-core kernel (`ssd_mma_kernel`, one head a
block); fp32 inputs and other shapes to the
scalar kernel (`ssd_scan_kernel`). `ssd.launches` counts both routes,
`ssd.mma_launches` the tensor-core launches alone; `reset_launches()`
sets both back to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.launch import SMEM_LIMIT, check_launch, placement, stream_args
from repro_torch.kernels.ssd_scan import ref

__all__ = ["reset_launches", "ssd"]

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    ssd.launches = 0
    ssd.mma_launches = 0


def _packed(t: torch.Tensor, inner: int) -> bool:
    """The last `inner` dims of t are packed (row-major, no gaps)."""
    want = 1
    for d in range(t.dim() - 1, t.dim() - 1 - inner, -1):
        if t.shape[d] > 1 and t.stride(d) != want:
            return False
        want *= t.shape[d]
    return True


def ssd(x: torch.Tensor, dt: torch.Tensor, a_per_head: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H); a_per_head: (H,) negative decay
    rates; b, c: (B, L, G, N), H % G == 0. Returns (y (B, L, H, P) in x's
    dtype, s_final (B, H, N, P) fp32)."""
    name = "ssd"
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError(f"{name}: want x (B,L,H,P), dt (B,L,H), b/c (B,L,G,N)")
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (dt.shape != (B, L, H) or a_per_head.shape != (H,) or c.shape != b.shape
            or b.shape[:2] != (B, L) or G < 1 or H % G != 0):
        raise ValueError(
            f"{name}: shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a_per_head.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    assert L % chunk == 0, (L, chunk)
    if placement(name, (x, dt, a_per_head, b, c)) == "cpu":
        return ref.ssd(x, dt, a_per_head, b, c, chunk=chunk)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError(f"{name}: x, dt, b, c must share one dtype of {_DTYPES}; got "
                        f"{x.dtype}, {dt.dtype}, {b.dtype}, {c.dtype}")
    if a_per_head.dtype != torch.float32:
        raise TypeError(f"{name}: a_per_head must be float32, got {a_per_head.dtype}")
    if not (_packed(x, 2) and _packed(dt, 1) and _packed(b, 2) and _packed(c, 2)
            and a_per_head.is_contiguous()):
        raise ValueError(f"{name}: the inner dims of x (H,P), dt (H), b/c (G,N) "
                         "must be packed")
    from repro_torch.kernels.ssd_scan import build

    lib = build.load()
    mma = x.dtype == torch.bfloat16 and bool(lib.ssd_mma_supported(chunk, N, P))
    smem = (lib.ssd_mma_smem_bytes(chunk, N, P) if mma      # the kernels' own layouts
            else lib.ssd_smem_bytes(chunk, N, P))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} B of shared memory at chunk={chunk}, N={N}, "
                         f"P={P} exceeds {SMEM_LIMIT} B")
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    s = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, s
    device, stream = stream_args(x)
    args = (x.data_ptr(), x.stride(0), x.stride(1),
            dt.data_ptr(), dt.stride(0), dt.stride(1), a_per_head.data_ptr(),
            b.data_ptr(), b.stride(0), b.stride(1), c.data_ptr(), c.stride(0), c.stride(1),
            y.data_ptr(), s.data_ptr(), B, L, H, G, N, P, chunk, device, stream)
    if mma:
        err = lib.ssd_scan_mma(*args)
    else:
        err = lib.ssd_scan(int(x.dtype == torch.bfloat16), *args)
    check_launch(err, lib.ssd_error_string, name)
    ssd.launches += 1
    ssd.mma_launches += int(mma)
    return y, s


reset_launches()
