"""Normalization layers (fp32 statistics regardless of compute dtype).

Counterpart of `repro/layers/norms.py`: RMSNorm, with gemma's (1 + w)
scale (`plus_one`, the scale initialized to zeros), and LayerNorm.
"""
from __future__ import annotations

import torch

from repro_torch.models.base import ParamInfo

__all__ = ["rmsnorm_params", "layernorm_params", "norm_params", "apply_norm"]


def rmsnorm_params(d: int, n_layers: int | None = None, *, plus_one: bool = False) -> dict:
    shape = (d,) if n_layers is None else (n_layers, d)
    # gemma parameterizes scale as (1 + w) with w init 0; others init 1.
    return {"scale": ParamInfo(shape, torch.float32, (None,) * len(shape),
                               init="zeros" if plus_one else "ones")}


def layernorm_params(d: int, n_layers: int | None = None) -> dict:
    shape = (d,) if n_layers is None else (n_layers, d)
    return {"scale": ParamInfo(shape, torch.float32, (None,) * len(shape), init="ones"),
            "bias": ParamInfo(shape, torch.float32, (None,) * len(shape), init="zeros")}


def norm_params(kind: str, d: int, n_layers: int | None = None, *,
                plus_one: bool = False) -> dict:
    if kind == "rmsnorm":
        return rmsnorm_params(d, n_layers, plus_one=plus_one)
    if kind == "layernorm":
        return layernorm_params(d, n_layers)
    raise ValueError(kind)


def apply_norm(kind: str, p: dict, x: torch.Tensor, *, eps: float,
               plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        scale = p["scale"] + 1.0 if plus_one else p["scale"]
        return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)
    raise ValueError(kind)
