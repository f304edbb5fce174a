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

Expert parallelism (ROADMAP.md A.7d), the reference's default (GSPMD)
semantics: under a model group whose ranks hold shards of the expert
leaves (E/m experts a rank, `parallel/tensor.py`), every rank of the
group routes all of its data shard's tokens from the replicated input,
so the capacity, the queues and the kept pairs are the unmeshed layer's
(decode's capacity of 1 included). A rank then fills only its own
experts' rows of the buffer (`dispatch`'s `experts`; `rows` the
capacity, or in a data-parallel step the most that one of its experts
keeps), runs their SwiGLU on its shards and scatters its kept pairs'
gated outputs into a (T, D) partial, which `tensor.reduce_from` sums
over the group: one all-reduce a layer. The router and the aux losses
read the replicated input, so their gradients are whole on every rank;
the tokens that enter the buffer and the gates pass through
`tensor.copy_to`, whose backward sums over the group the partial input
and gate gradients that each rank's experts give. The router's and the
input's gradients come out whole, with no sum in the train step. Where
E does not divide the axis the expert leaves stay whole on every rank
(a recorded fallback) and the layer runs whole there.

With x split along the sequence between layers (`seq`, this rank's
positions; ROADMAP.md A item 4), the layer gathers the sequence
(`tensor.gather_seq`) before routing, so the routing stays replicated
over the model group: the dispatch, the capacity and the kept pairs are
the unmeshed layer's. The aux losses keep their values: each rank takes
its positions' router statistics and sums them over the model group as
over the data group (`data_parallel.sum_over`, whose backward gives each
rank its positions' share). Without `copy_to`, each rank's gradients of
the gathered tokens and of the gates are its experts' part and its
positions' aux part, which the gather's reduce-scatter sums once; the
router's gradient is that part too, which the train step sums over the
model group. The (T, D) partial is reduce-scattered back to this rank's
positions (`scatter_seq` in place of `reduce_from`); whole experts give
the whole output on every rank, of which the rank keeps its positions.
Under the "shardmap" flag the layer takes the whole sequence
(`gather_from`) and keeps its positions of the replicated output
(`split_seq`), so `moe_shardmap` runs as it does unsplit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.layers.common import is_q
from repro_torch.models import runtime
from repro_torch.models.base import ArchConfig, ParamInfo
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor

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
             first: torch.Tensor | None = None, rows: int | None = None,
             experts: tuple[int, int] | None = None):
    """Sort the T·K routed pairs by expert (stably, so a token's place in
    its expert's queue follows token order) and give each a slot in the
    (n·rows + 1) buffer of the n experts of `experts` ((first expert, n);
    default all E), the last slot being the overflow bin. A pair is kept
    when its place in its expert's queue is below `cap`; a kept pair of
    an expert outside `experts` goes to the overflow bin too. `first` (E,)
    is each expert's queue place of this batch's first pair (the pairs of
    the ranks before this one in a data-parallel step); `rows` (default
    `cap`) is the buffer's slots per expert, which must hold this batch's
    kept pairs of each expert of `experts`. Returns (token, gate, slot,
    keep) of the pairs in sorted order; the pairs the buffer holds are
    those whose slot is below n·rows."""
    T, K = ids.shape
    rows = cap if rows is None else rows
    e0, n = (0, n_experts) if experts is None else experts
    flat_expert = ids.reshape(-1)
    flat_token = torch.arange(T, device=ids.device).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    se, stok, sgate = flat_expert[order], flat_token[order], gates.reshape(-1).float()[order]
    seg_start = torch.searchsorted(se, torch.arange(n_experts, device=ids.device), side="left")
    pos_in_expert = torch.arange(se.numel(), device=ids.device) - seg_start[se]
    keep = pos_in_expert + (0 if first is None else first[se]) < cap
    held = keep if experts is None else keep & (se >= e0) & (se < e0 + n)
    slot = torch.where(held, (se - e0) * rows + pos_in_expert, n * rows)
    return stok, sgate, slot, keep


def moe(cfg: ArchConfig, p: dict, x: torch.Tensor, *, capacity_factor: float = 1.25,
        group=None, seq=None) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), {"lb_loss", "z_loss"}). `group`: the
    model group when the expert leaves of `p` are this rank's shards
    (expert parallelism; see the module's docstring); `seq`: this rank's
    positions when x holds them."""
    if any(is_q(p[k]) for k in ("wi", "wg", "wo")):
        raise TypeError(
            "W8 expert weights are not served: the reference reads them with "
            "`.astype` (repro/layers/moe.py:116), which fails on a {'q', 's'} leaf")
    if runtime.flag("moe_impl") == "shardmap" and shd.active_mesh() is not None:
        from repro_torch.layers.moe_shardmap import moe_shardmap
        if seq is None:
            return moe_shardmap(cfg, p, x, capacity_factor=capacity_factor)
        out, aux = moe_shardmap(cfg, p, tensor.gather_from(x, group, dim=1),
                                capacity_factor=capacity_factor)
        return tensor.split_seq(out, group), aux
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    El = p["wi"].shape[-3]                     # this rank's experts
    dt = x.dtype

    if seq is not None:                        # the whole sequence, routed on every rank
        x = tensor.gather_seq(x, group)
        S = x.shape[1]
    T = B * S
    xt = x.reshape(T, D)

    logits, probs, gates, ids = route(cfg, p["router"], xt)
    own = logits
    if seq is not None:                        # the aux losses' share of this rank's positions
        own = logits.reshape(B, S, E).narrow(1, *seq).reshape(-1, E)
        probs = probs.reshape(B, S, E).narrow(1, *seq).reshape(-1, E)
    # aux: load balance (mean prob x assignment fraction) + z-loss, over
    # the global batch inside a data-parallel step (and the model group
    # where the sequence is split), both statistics in one sum; the
    # assignments counted by a scatter-add, not a (T, K, E) one-hot
    n_tok = T * dp.size()
    stats = torch.cat([probs.sum(dim=0), torch.sum(torch.logsumexp(own, dim=-1) ** 2)[None]])
    stats = dp.global_sum(stats if seq is None else dp.sum_over(stats, group)) / n_tok
    me, z_loss = stats[:E], stats[E]
    local_counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(T * K, dtype=torch.float32, device=x.device))
    counts = dp.global_sum(local_counts)
    lb_loss = E * torch.sum(me * (counts / n_tok))

    # this rank's experts [e0, e0 + El): all E unless the leaves are shards
    e0, experts = 0, None
    if El < E:
        e0 = dist.get_rank(group) * El
        experts = (e0, El)
        if seq is None:
            xt, gates = tensor.copy_to(xt, group), tensor.copy_to(gates, group)
    # the capacity and the experts' queues are the global batch's; this
    # rank's buffer holds only its own kept pairs (rows per expert: the
    # most that one of its experts keeps of them, read on the host)
    cap = capacity(n_tok, K, E, capacity_factor)
    first, rows = None, cap
    if dp.size() > 1:
        first = dp.exclusive_sum(local_counts).long()
        kept = torch.minimum((cap - first).clamp(min=0), local_counts.long())[e0:e0 + El]
        # on meta (launch/dryrun.py) there is no value to read: the bound
        rows = cap if kept.is_meta else max(1, int(kept.max()))
    stok, sgate, slot, _ = dispatch(ids, gates, E, cap, first, rows, experts)
    # every pair the buffer does not hold lands in the overflow slot, which
    # is cut off (no boolean mask: the shapes stay data-independent, meta
    # tensors too)
    held = slot < El * rows
    buf_tok = torch.zeros(El * rows + 1, dtype=torch.long, device=x.device)
    buf_tok[slot] = stok
    xe = xt[buf_tok[:El * rows]].reshape(El, rows, D)

    h = torch.bmm(xe, p["wi"].to(dt))
    g = torch.bmm(xe, p["wg"].to(dt))
    h = F.silu(g.float()).to(dt) * h
    ye = torch.bmm(h, p["wo"].to(dt)).reshape(El * rows, D)

    contrib = ye[torch.where(held, slot, 0)] * (sgate * held.float())[:, None].to(dt)
    out = torch.zeros((T, D), dtype=dt, device=x.device).index_add_(0, stok, contrib)
    out = out.reshape(B, S, D)
    if seq is not None:
        out = tensor.scatter_seq(out, group) if experts else out.narrow(1, *seq)
    elif experts is not None:
        out = tensor.reduce_from(out, group)
    return out, {"lb_loss": lb_loss, "z_loss": z_loss}
