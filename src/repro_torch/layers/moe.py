"""Mixture-of-Experts block: top-k router + sort-based dispatch.

Counterpart of `repro/layers/moe.py`. Dispatch is gather and scatter
based (a stable sort of the routed pairs by expert id, bounded by a
capacity per expert), not a one-hot product. The reference's mesh
flag `moe_impl` is read through `models.runtime.flag`: "shardmap"
under an active mesh sends the layer to `layers/moe_shardmap.py` (the
all-to-all dispatch over the mesh's model axis). The reference's
`moe_token_shard` and `moe_expert_aligned` only annotate the layouts of
the tokens and the expert buffer; the port carries no activation
annotations (ROADMAP.md C), so it ignores them and they change no
result, as in the reference.

The router runs in fp32: softmax, top-k, then (`moe_norm_topk`) the
gates renormalized to sum to 1. Top-k breaks ties towards the lower
expert index, as `jax.lax.top_k` does (`torch.topk` does not promise
that), through a stable descending sort. The capacity is Python
arithmetic on the token count T = B·S: `min(int(max(1, cf·T·K/E)), T)`,
so a decode step of 4 tokens gives capacity 1 and drops most of its
routed pairs, as the reference does. Pairs beyond an expert's capacity
go to an overflow slot whose output is dropped. The experts are batched
SwiGLU products in the compute dtype (the activation in fp32); the
combine is a gated `index_add_` in the compute dtype.

Aux losses: load-balancing (Switch-style) and the router z-loss, for the
trainer to weight (`models/api.py`). Their router statistics are sums
over the tokens divided by the token count, each sum taken through
`data_parallel.global_sum`: inside a data-parallel train step they are
the global batch's, so the losses equal the single-process step's; so
are the capacity and each expert's queue (`dispatch`'s `first`), so the
same routed pairs are kept or dropped. Each rank's expert buffer holds
only its own kept pairs, so a rank does its share of the expert
products, not the global batch's. On `meta` tensors (the dry run's
counting step) that most cannot be read, and the buffer holds `cap`
rows per expert, the bound it cannot exceed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.common import is_q
from repro_torch.models import runtime
from repro_torch.models.base import ArchConfig, ParamInfo
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as shd

__all__ = ["moe_params", "capacity", "route", "dispatch", "moe"]


def moe_params(cfg: ArchConfig, n_layers: int | None = None) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = () if n_layers is None else (n_layers,)
    nl = (None,) * len(L)
    fan = len(L)
    f32 = torch.float32
    return {
        "router": ParamInfo(L + (d, E), f32, nl + ("fsdp", None), fan=fan),
        "wi": ParamInfo(L + (E, d, f), f32, nl + ("experts", "fsdp", None), fan=fan + 1),
        "wg": ParamInfo(L + (E, d, f), f32, nl + ("experts", "fsdp", None), fan=fan + 1),
        "wo": ParamInfo(L + (E, f, d), f32, nl + ("experts", None, "fsdp"), fan=fan + 1),
    }


def capacity(n_tokens: int, k: int, n_experts: int, capacity_factor: float = 1.25) -> int:
    """Routed pairs each expert takes: the reference's Python arithmetic."""
    return min(int(max(1, capacity_factor * n_tokens * k / n_experts)), n_tokens)


def route(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor):
    """The fp32 router over tokens xt (T, D). Returns (logits (T, E), probs
    (T, E), gates (T, K), expert ids (T, K)); ties go to the lower id."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :cfg.experts_per_token], ids[:, :cfg.experts_per_token]
    if cfg.moe_norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return logits, probs, gates, ids


def dispatch(ids: torch.Tensor, gates: torch.Tensor, n_experts: int, cap: int,
             first: torch.Tensor | None = None, rows: int | None = None):
    """Sort the T·K routed pairs by expert (stably, so a token's place in
    its expert's queue follows token order) and give each a slot in the
    (E·rows + 1) buffer, the last slot being the overflow bin. A pair is
    kept when its place in its expert's queue is below `cap`. `first`
    (E,) is each expert's queue place of this batch's first pair (the
    pairs of the ranks before this one in a data-parallel step); `rows`
    (default `cap`) is the buffer's slots per expert, which must hold
    this batch's kept pairs of each expert. Returns (token, gate, slot,
    keep) of the pairs in sorted order."""
    T, K = ids.shape
    rows = cap if rows is None else rows
    flat_expert = ids.reshape(-1)
    flat_token = torch.arange(T, device=ids.device).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    se, stok, sgate = flat_expert[order], flat_token[order], gates.reshape(-1).float()[order]
    seg_start = torch.searchsorted(se, torch.arange(n_experts, device=ids.device), side="left")
    pos_in_expert = torch.arange(se.numel(), device=ids.device) - seg_start[se]
    keep = pos_in_expert + (0 if first is None else first[se]) < cap
    slot = torch.where(keep, se * rows + pos_in_expert, n_experts * rows)
    return stok, sgate, slot, keep


def moe(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
        capacity_factor: float = 1.25) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), {"lb_loss", "z_loss"})."""
    if any(is_q(p[k]) for k in ("wi", "wg", "wo")):
        raise TypeError(
            "W8 expert weights are not served: the reference reads them with "
            "`.astype` (repro/layers/moe.py:116), which fails on a {'q', 's'} leaf")
    if runtime.flag("moe_impl") == "shardmap" and shd.active_mesh() is not None:
        from repro_torch.layers.moe_shardmap import moe_shardmap
        return moe_shardmap(cfg, p, x, capacity_factor=capacity_factor)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)

    logits, probs, gates, ids = route(cfg, p["router"], xt)
    # aux: load balance (mean prob x assignment fraction) + z-loss, over
    # the global batch inside a data-parallel step; the assignments
    # counted by a scatter-add, not a (T, K, E) one-hot
    n_tok = T * dp.size()
    me = dp.global_sum(probs.sum(dim=0)) / n_tok
    local_counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(T * K, dtype=torch.float32, device=x.device))
    counts = dp.global_sum(local_counts)
    lb_loss = E * torch.sum(me * (counts / n_tok))
    z_loss = dp.global_sum(torch.sum(torch.logsumexp(logits, dim=-1) ** 2)) / n_tok

    # the capacity and the experts' queues are the global batch's; this
    # rank's buffer holds only its own kept pairs (rows per expert: the
    # most that any expert keeps of them, read on the host)
    cap = capacity(n_tok, K, E, capacity_factor)
    first, rows = None, cap
    if dp.size() > 1:
        first = dp.exclusive_sum(local_counts).long()
        kept = torch.minimum((cap - first).clamp(min=0), local_counts.long())
        # on meta (launch/dryrun.py) there is no value to read: the bound
        rows = cap if kept.is_meta else max(1, int(kept.max()))
    stok, sgate, slot, keep = dispatch(ids, gates, E, cap, first, rows)
    # every dropped pair lands in the overflow slot, which is cut off (no
    # boolean mask: the shapes stay data-independent, meta tensors too)
    buf_tok = torch.zeros(E * rows + 1, dtype=torch.long, device=x.device)
    buf_tok[slot] = stok
    xe = xt[buf_tok[:E * rows]].reshape(E, rows, D)

    h = torch.bmm(xe, p["wi"].to(dt))
    g = torch.bmm(xe, p["wg"].to(dt))
    h = F.silu(g.float()).to(dt) * h
    ye = torch.bmm(h, p["wo"].to(dt)).reshape(E * rows, D)

    contrib = ye[torch.where(keep, slot, 0)] * (sgate * keep.float())[:, None].to(dt)
    out = torch.zeros((T, D), dtype=dt, device=x.device).index_add_(0, stok, contrib)
    return out.reshape(B, S, D), {"lb_loss": lb_loss, "z_loss": z_loss}
