"""Weight access supporting quantized (int8 + per-channel scale) leaves.

Counterpart of `repro/layers/common.py`. A parameter leaf is either a
tensor or `{"q": int8, "s": fp32}` (per-output-channel scales over the
LAST dim); `wx(w, dtype)` returns the compute-dtype weight either way.

`quantize_params_for_serving` gives every weight of three or more dims
per-(first dim, last dim) scales, meant for a stack of layers whose slice
reaches `wx` with scales over its last dim alone. An un-stacked weight of
three dims (zamba's shared attention `wq`/`wk`/`wv` (d, H, hd) and `wo`
(H, hd, d)) reaches `wx` whole, with its (first, last) scales; `wx`
broadcasts them over the middle dims. The reference multiplies them as
they are, which raises a broadcasting error (`repro/layers/common.py:25`):
its W8 zamba2 runs only while those weights stay below the quantization's
size floor, as at the smoke size (ROADMAP.md, C).

Every call is a `weights.cast` span (`netgen.telemetry`), its `bytes` the
cast's output (0 where the leaf already has the dtype and nothing is
written).
"""
from __future__ import annotations

import torch

from repro_torch.netgen import telemetry

__all__ = ["is_q", "wx"]


def is_q(w) -> bool:
    return isinstance(w, dict) and set(w.keys()) == {"q", "s"}


def wx(w, dtype: torch.dtype) -> torch.Tensor:
    """Materialize a weight in compute dtype (dequantizing in fp32 first)."""
    with telemetry.span("weights.cast") as sp:
        if is_q(w):
            q, s = w["q"], w["s"]
            if q.dim() >= 3 and s.dim() == 2:      # an un-stacked weight: (first, last) scales
                s = s.reshape(s.shape[0], *([1] * (q.dim() - 2)), s.shape[1])
            out = (q.float() * s).to(dtype)
        else:
            out = w.to(dtype)
        sp.set_attr("bytes", 0 if out is w else out.nbytes)
    return out
