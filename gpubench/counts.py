"""The yardstick's arithmetic: peaks of the card, and the operations and
bytes of the work, computed from shapes alone.

Nothing here reads a counter of the program; every number follows from
the configuration file's `arch` table and a batch's rows and prompt
length, so it reads the same work whatever kernels carry it out.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 989e12 bf16 FLOP/s on
the tensor cores and 3.35e12 B/s of HBM3, at the 700 W power limit.

`ssd_forward` is the SSD chunk scan's count (operations at chunk
`SSD_CHUNK`, whatever chunk the kernel runs): scores 2·B·S·Q·H·N, the
intra-chunk output 2·B·S·Q·H·P, the inter-chunk output and the states
4·B·S·H·N·P, and the decay 3·B·S·Q·H. Its bytes are the kernel's
inputs read once and its outputs written once: x, dt, b and c in
bfloat16, a in float32, y in bfloat16 and the final state in float32.

A configuration's own count of a prefill's work, `prefill_flops`, is
in the reference module that it names (`reference/<name>.py`), beside
the equations that it counts.
"""
from __future__ import annotations

__all__ = ["PEAK_BF16_FLOPS", "HBM_BYTES_PER_S", "SSD_CHUNK", "ssd_dims", "ssd_forward",
           "ssd_bound_s"]

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
SSD_CHUNK = 128


def ssd_dims(arch: dict) -> tuple[int, int, int, int]:
    """(heads, head dim, state, groups) of a Mamba2 mixer's SSD."""
    di = arch["ssm_expand"] * arch["d_model"]
    P = arch["ssm_headdim"]
    return di // P, P, arch["ssm_state"], arch["ssm_groups"]


def ssd_forward(B: int, S: int, H: int, P: int, N: int, G: int,
                Q: int = SSD_CHUNK) -> tuple[int, int]:
    """(operations, bytes) of one SSD scan over B rows of S positions."""
    ops = 2 * B * S * H * (Q * N + Q * P + 2 * N * P) + 3 * B * S * Q * H
    nbytes = (2 * B * S * H * P          # x
              + 2 * B * S * H            # dt
              + 4 * H                    # a
              + 2 * 2 * B * S * G * N    # b, c
              + 2 * B * S * H * P        # y
              + 4 * B * H * N * P)       # final state
    return ops, nbytes


def ssd_bound_s(arch: dict, rows: int, length: int) -> float:
    """The least time one mixer's SSD scan can take on the card: the
    larger of its operations over the bf16 peak and its bytes over HBM's."""
    H, P, N, G = ssd_dims(arch)
    ops, nbytes = ssd_forward(rows, length, H, P, N, G)
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
