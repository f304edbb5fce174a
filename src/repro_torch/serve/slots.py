"""Fixed-capacity slot batching for the port's servers.

A copy of `repro/serve/slots.py`, kept in the port so that it imports
nothing of the JAX package. Requests are padded into fixed-size slot
blocks so every served function sees exactly one batch shape. The
netgen predictor server (`repro_torch.netgen.serve`) slots uint8 image
batches. Depends on numpy only.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["pad_slots", "stack_requests"]


def pad_slots(x: np.ndarray, capacity: int) -> tuple[np.ndarray, int]:
    """Pad a request batch into a fixed-capacity slot block (leading axis).

    Padding rows are zeros; the returned int is the number of valid
    leading rows. Raises when the batch exceeds the capacity — chunking
    policy belongs to the caller.
    """
    x = np.asarray(x)
    n = x.shape[0]
    if n > capacity:
        raise ValueError(f"batch of {n} exceeds slot capacity {capacity}")
    if n == capacity:
        return x, n
    pad = np.zeros((capacity - n,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n


def stack_requests(rows: Sequence[np.ndarray]) -> np.ndarray:
    """Stack single requests (each one feature vector) into a batch.

    The admission side of an online serving engine holds individual
    requests; the dispatch side wants one (B, features) array to pad
    into a slot block. Rows must agree in shape and dtype — a mixed
    batch would silently upcast and defeat the servers' strict uint8
    validation.
    """
    if not rows:
        raise ValueError("no requests to stack")
    first = np.asarray(rows[0])
    for r in rows[1:]:
        r = np.asarray(r)
        if r.shape != first.shape or r.dtype != first.dtype:
            raise ValueError(
                f"requests disagree in shape/dtype: {first.shape}/"
                f"{first.dtype} vs {r.shape}/{r.dtype}")
    return np.stack([np.asarray(r) for r in rows], axis=0)
