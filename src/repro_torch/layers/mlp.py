"""Feed-forward blocks: SwiGLU (llama/qwen), GeGLU (gemma), GELU (musicgen).

Counterpart of `repro/layers/mlp.py`. The activation is computed in fp32
and cast to the compute dtype before the product; GELU is the tanh
approximation, as the reference's `approximate=True`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.common import wx
from repro_torch.models.base import ArchConfig, ParamInfo

__all__ = ["mlp_params", "mlp"]


def mlp_params(cfg: ArchConfig, n_layers: int | None = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    L = () if n_layers is None else (n_layers,)
    fan = len(L)
    p = {"wi": ParamInfo(L + (d, f), torch.float32, fan=fan),
         "wo": ParamInfo(L + (f, d), torch.float32, fan=fan)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = ParamInfo(L + (d, f), torch.float32, fan=fan)
    return p


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    dt = x.dtype
    h = torch.matmul(x, wx(p["wi"], dt))
    if cfg.act == "swiglu":
        g = torch.matmul(x, wx(p["wg"], dt))
        h = F.silu(g.float()).to(dt) * h
    elif cfg.act == "geglu":
        g = torch.matmul(x, wx(p["wg"], dt))
        h = F.gelu(g.float(), approximate="tanh").to(dt) * h
    elif cfg.act == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(dt)
    else:
        raise ValueError(cfg.act)
    return torch.matmul(h, wx(p["wo"], dt))
