"""Normalization (fp32 statistics regardless of compute dtype).

Counterpart of `repro/layers/norms.py` for the ported families, which
use RMSNorm with a scale initialized to 1. LayerNorm and gemma's (1 + w)
scale come with their families (ROADMAP.md, A.10).
"""
from __future__ import annotations

import torch

from repro_torch.models.base import ParamInfo

__all__ = ["norm_params", "apply_norm"]


def _check(kind: str) -> None:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r} is not ported yet (ROADMAP.md, A.10); rmsnorm is")


def norm_params(kind: str, d: int, n_layers: int | None = None) -> dict:
    _check(kind)
    shape = (d,) if n_layers is None else (n_layers, d)
    return {"scale": ParamInfo(shape, torch.float32, init="ones")}


def apply_norm(kind: str, p: dict, x: torch.Tensor, *, eps: float) -> torch.Tensor:
    _check(kind)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)
