"""Feed-forward blocks: SwiGLU (llama/qwen), GeGLU (gemma), GELU (musicgen).

Counterpart of `repro/layers/mlp.py`. The activation is computed in fp32
and cast to the compute dtype before the product; GELU is the tanh
approximation, as the reference's `approximate=True`. Under a model axis
above 1 (`group`, `parallel/tensor.py`) `wi` and `wg` hold this rank's
ffn columns and `wo` its rows: x enters through `copy_to` (its gradient
summed over the group) and one all-reduce sums the output
(`reduce_from`). An ffn that does not divide the axis stays whole and
runs whole, with neither. A W8 leaf splits as its `q` does: the scales
of `wi` and `wg` are this rank's columns', those of `wo` whole. With x
split along the sequence (`seq`, ROADMAP.md A item 4) a split ffn
gathers it (`tensor.gather_seq` in place of `copy_to`) and
reduce-scatters the output back to this rank's positions (`scatter_seq`
in place of `reduce_from`); a whole ffn runs on this rank's positions,
and its gradients are then their part, which the train step sums.

`adapted_mlp` is Zamba2's shared MLP (`models/zamba.py`'s published
layout): one gate|up product, the site's low-rank adapter added to it,
and the exact (erf) GELU of the gate times the up half; it runs whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.common import is_q, wx
from repro_torch.models.base import ArchConfig, ParamInfo
from repro_torch.parallel import tensor

__all__ = ["mlp_params", "mlp", "adapted_mlp_params", "adapted_mlp"]


def mlp_params(cfg: ArchConfig, n_layers: int | None = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    L = () if n_layers is None else (n_layers,)
    nl = (None,) * len(L)
    fan = len(L)
    p = {"wi": ParamInfo(L + (d, f), torch.float32, nl + ("fsdp", "ffn"), fan=fan),
         "wo": ParamInfo(L + (f, d), torch.float32, nl + ("ffn", "fsdp"), fan=fan)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = ParamInfo(L + (d, f), torch.float32, nl + ("fsdp", "ffn"), fan=fan)
    return p


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor, group=None, seq=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); `group` the model group when p holds
    shards; `seq` this rank's positions when x holds them."""
    dt = x.dtype
    wi = p["wi"]["q"] if is_q(p["wi"]) else p["wi"]
    split = group is not None and wi.shape[-1] < cfg.d_ff
    if split:
        x = tensor.copy_to(x, group) if seq is None else tensor.gather_seq(x, group)
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
    out = torch.matmul(h, wx(p["wo"], dt))
    if not split:
        return out
    return tensor.reduce_from(out, group) if seq is None else tensor.scatter_seq(out, group)


def adapted_mlp_params(cfg: ArchConfig, n_blocks: int) -> dict:
    """Abstract params of `n_blocks` stacked adapted MLPs: the fused
    gate|up (d, 2 d_ff) and down (d_ff, d)."""
    d, f = cfg.d_model, cfg.d_ff
    return {"gate_up": ParamInfo((n_blocks, d, 2 * f), torch.float32, (None, None, None), fan=1),
            "down": ParamInfo((n_blocks, f, d), torch.float32, (None, None, None), fan=1)}


def adapted_mlp(p: dict, x: torch.Tensor, adapter_a, adapter_b) -> torch.Tensor:
    """down(gelu_erf(g) · u), [g | u] = x W_gate_up + (x A) B with the
    site's adapter A (d, r), B (r, 2 d_ff); the GELU in fp32.
    x: (B, S, D) -> (B, S, D)."""
    dt = x.dtype
    gu = torch.matmul(x, wx(p["gate_up"], dt))
    xa = torch.matmul(x, wx(adapter_a, dt))   # the low-rank term added in place: no
    gu.view(-1, gu.shape[-1]).addmm_(xa.view(-1, xa.shape[-1]), wx(adapter_b, dt))  # 2nd buffer
    g, u = gu.chunk(2, dim=-1)
    h = F.gelu(g.float()).to(dt) * u
    return torch.matmul(h, wx(p["down"], dt))
