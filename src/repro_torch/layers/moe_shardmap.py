"""MoE dispatch with explicit all-to-all over the mesh's model axis.

Counterpart of `repro/layers/moe_shardmap.py` (the Switch decomposition:
each rank routes its own tokens, buckets them by the model rank that
owns their expert, and one all-to-all over the model axis delivers
them). The reference writes the body once for `shard_map`; here every
rank runs it on its own tensors with explicit collectives over the
active mesh's process groups (`launch.mesh.Mesh.group`):

  * x is this rank's data shard (B_loc, S, D), the same on every rank
    of the model axis; its B_loc·S tokens split into mp slices, one per
    model rank (`_Scatter`);
  * local routing (`layers.moe.route`: fp32, ties to the lower expert)
    through `tensor.copy_to` on the router (identity forward, all-reduce
    of its gradient over the model axis backward), the reference's
    per-shard load-balance and z losses, averaged over
    the model axis, then over the data axis (`data_parallel.sum_over`,
    whose backward gives each rank its share);
  * `_bucket_by_dest`: the routed pairs sorted stably by destination
    rank, cap = int(max(1, cf·T_loc·K / mp)) rows per destination, the
    rest dropped; metadata [local expert, gate, source row], -1 in
    padded slots;
  * `all_to_all_single` out (`_AllToAll`); the received rows sorted by
    local expert into cap_e = int(max(1, 2·mp·cap // e_loc)) slots each
    (mean plus 2x imbalance headroom); the SwiGLU experts of this rank,
    E/mp of them: the expert leaves when they are this rank's shards
    (`parallel/tensor.py` cuts them over "model"), else sliced from the
    whole ones; `all_to_all_single`
    home; the gated scatter-add at the source;
  * `all_gather` over the model axis of the mp token slices (`_Gather`).

Rows beyond an expert's cap_e are dropped. The reference writes them at
le·cap_e + pos, past its expert's slots and into the next expert's, whose
rows they may overwrite (a fault: ROADMAP.md, C); the two agree whenever
no expert overflows cap_e, as at the capacity factors of the tests.

Differentiable: each collective is a `torch.autograd.Function`. The
output is replicated over the model axis, and the backward treats the
loss as computed once from it: `_Gather`'s backward keeps this rank's
slice of the gradient, `_Scatter`'s gathers every slice's, so each model
rank gets the whole input gradient; the expert weights get theirs from
every token routed to them. Each rank routes its own T/mp tokens, so its
router gradient, from its tokens' gates and its share of the aux
losses, is a part of the whole: the `copy_to` on the router sums it
over the model axis in the backward, and every rank gets the whole
router gradient, as the reference's replicated router (`P(None, None)`)
gets it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.layers.moe import route
from repro_torch.models.base import ArchConfig
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor

__all__ = ["moe_shardmap"]


class _AllToAll(torch.autograd.Function):
    """all_to_all_single along dim 0 in equal splits; its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _all_gather(x, group, n):
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _Scatter(torch.autograd.Function):
    """This rank's slice of dim 0; backward gathers every rank's slice."""

    @staticmethod
    def forward(ctx, x, group, idx, n):
        ctx.group, ctx.n = group, n
        m = x.shape[0] // n
        return x[idx * m:(idx + 1) * m].clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.n), None, None, None


class _Gather(torch.autograd.Function):
    """Every rank's slice concatenated on dim 0; backward keeps this rank's."""

    @staticmethod
    def forward(ctx, x, group, idx, n):
        ctx.idx, ctx.m = idx, x.shape[0]
        return _all_gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.idx * ctx.m:(ctx.idx + 1) * ctx.m].contiguous(), None, None, None


def _bucket_by_dest(ids, gates, xt, *, n_dest: int, cap: int, e_loc: int):
    """Group routed (token, expert) pairs into per-destination buckets.
    ids/gates: (T*K,), xt: (T, D). Returns send buffers:
      xs   (n_dest, cap, D)   token vectors
      meta (n_dest, cap, 3)   [local_expert, gate, src_row] (-1 pad)
    """
    TK = ids.shape[0]
    T, D = xt.shape
    dev = ids.device
    dest = ids // e_loc
    order = torch.argsort(dest, stable=True)
    d_s, ids_s, gates_s = dest[order], ids[order], gates[order]
    src_s = (torch.arange(TK, device=dev) // (TK // T))[order]

    seg_start = torch.searchsorted(d_s, torch.arange(n_dest, device=dev), side="left")
    pos_in_dest = torch.arange(TK, device=dev) - seg_start[d_s]
    keep = pos_in_dest < cap
    slot = (d_s * cap + pos_in_dest)[keep]

    xs = xt.new_zeros((n_dest * cap, D)).index_put((slot,), xt[src_s[keep]])
    rows3 = torch.stack([(ids_s % e_loc).float(), gates_s, src_s.float()], dim=-1)
    meta = torch.full((n_dest * cap, 3), -1.0, device=dev).index_put((slot,), rows3[keep])
    return xs.reshape(n_dest, cap, D), meta.reshape(n_dest, cap, 3)


def moe_shardmap(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                 capacity_factor: float = 1.25) -> tuple[torch.Tensor, dict]:
    """Drop-in for `layers.moe.moe` under an active mesh with a model axis.
    x: (B_loc, S, D), this rank's data shard; p: the layer's weights, the
    expert leaves whole or this rank's shards. Returns (out (B_loc, S, D), {"lb_loss", "z_loss"})."""
    mesh = shd.active_mesh()
    if mesh is None or "model" not in mesh.shape:
        raise ValueError(f"moe_shardmap needs an active mesh with a model axis, got {mesh}")
    mp = mesh.shape["model"]
    E, K, D = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    if E % mp:
        raise ValueError(f"{E} experts do not divide over a model axis of {mp}")
    e_loc = E // mp
    gm, midx = mesh.group("model"), mesh.coordinate("model")
    B_loc, S, _ = x.shape
    T_all = B_loc * S
    if T_all % mp:
        raise ValueError(f"{T_all} tokens do not divide over a model axis of {mp}")
    T_loc = T_all // mp
    dt = x.dtype
    xt = _Scatter.apply(x.reshape(T_all, D), gm, midx, mp)

    # local routing and the reference's per-shard aux losses, then their
    # means over the model axis and the data axis
    logits, probs, gates, ids = route(cfg, tensor.copy_to(p["router"], gm), xt)
    me = probs.mean(dim=0)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(T_loc * K, dtype=torch.float32, device=x.device))
    lb = E * torch.sum(me * (counts / T_loc))
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    for axis in ("model", "data"):
        if axis in mesh.shape:
            group, n = mesh.group(axis), mesh.shape[axis]
            lb, zl = dp.sum_over(lb, group) / n, dp.sum_over(zl, group) / n

    cap = int(max(1, capacity_factor * T_loc * K / mp))
    xs, meta = _bucket_by_dest(ids.reshape(-1), gates.reshape(-1).float(), xt,
                               n_dest=mp, cap=cap, e_loc=e_loc)

    # the all-to-all: tokens travel to their experts' owners
    xr = _AllToAll.apply(xs, gm).reshape(mp * cap, D)
    mr = torch.empty_like(meta)
    dist.all_to_all_single(mr, meta.detach().contiguous(), group=gm)
    le = mr.reshape(mp * cap, 3)[:, 0]

    # bucket the received rows by local expert (padding sorts last)
    le_key = torch.where(le >= 0, le, float(e_loc)).long()
    order = torch.argsort(le_key, stable=True)
    le_s = le_key[order]
    cap_e = int(max(1, 2 * mp * cap // e_loc))
    seg = torch.searchsorted(le_s, torch.arange(e_loc, device=x.device), side="left")
    pie = torch.arange(mp * cap, device=x.device) - seg[le_s.clamp(0, e_loc - 1)]
    kept = (le_s < e_loc) & (pie < cap_e)
    slot = le_s * cap_e + pie
    xe = xr.new_zeros((e_loc * cap_e, D)).index_put(
        (slot[kept],), xr[order[kept]]).reshape(e_loc, cap_e, D)

    # this rank's experts (swiglu): its shards, or its slice of whole leaves
    mine = slice(midx * e_loc, (midx + 1) * e_loc)
    wi, wg, wo = (p[k] if p[k].shape[0] == e_loc else p[k][mine] for k in ("wi", "wg", "wo"))
    h = torch.bmm(xe, wi.to(dt))
    g = torch.bmm(xe, wg.to(dt))
    h = F.silu(g.float()).to(dt) * h
    ye = torch.bmm(h, wo.to(dt)).reshape(e_loc * cap_e, D)

    # un-bucket into received-row order, then all-to-all home
    back = torch.where(kept[:, None], ye[torch.where(kept, slot, 0)], 0.0).to(dt)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    y_home = _AllToAll.apply(back[inv].reshape(mp, cap, D), gm).reshape(mp * cap, D)

    # combine at the source: gated scatter-add by original token row
    meta_home = meta.reshape(mp * cap, 3)
    ok = meta_home[:, 0] >= 0
    src = torch.where(ok, meta_home[:, 2].long(), 0)
    contrib = torch.where(ok[:, None], y_home * meta_home[:, 1:2].to(dt), 0.0).to(dt)
    out_my = torch.zeros((T_loc, D), dtype=dt, device=x.device).index_add(0, src, contrib)

    out = _Gather.apply(out_my, gm, midx, mp)
    return out.reshape(B_loc, S, D), {"lb_loss": lb, "z_loss": zl}
