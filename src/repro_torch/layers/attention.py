"""Multi-head attention with GQA/MQA, RoPE/M-RoPE, and a KV cache.

Counterpart of `repro/layers/attention.py`. The parameters and the KV
cache carry the reference's logical axes (`models.base.tree_specs`). The
dense family under a model axis above 1 splits the heads (and, serving,
the cache) explicitly: `group` below, with the shards and the autograd
collectives of `parallel/tensor.py`, for serving (ROADMAP.md A.7a) and
training (A.7b) alike; with the hidden state split along the sequence
between layers (`seq`, A item 4) it gathers the sequence where the heads
split, and splits the query sequence where they stay whole, as the
reference's spec gives "model" to the query sequence then. The cache
layout is
(B, KV, S_max, hd); `cache_pos` is a per-sequence write index, which
lets the serving engine decode a batch whose sequences stand at other
positions. Every function returns new tensors and leaves its inputs as
they were, as the reference does.

The port keeps the reference's default variants: `grouped` GQA (query
heads reshaped (KV, rep) against K/V in their stored layout) and the
`where` cache update (a select over the whole cache). Its
`attn_impl`/`cache_update` flags are hill-climb variants for XLA on the
TPU (GSPMD's placement of a repeated KV, an in-place scatter) and are not
ported.

The port's widening (Zamba2's shared block, `models/zamba.py`): the
projections take an input wider than their output (`attn_params`'
`d_in`; `wo` gives the model width whatever x's is), and the scores'
scale is the caller's `scale` where given, else hd^-1/2, on every route.

The attention core (the flash loop, the dense scores, or a decode step's
against the cache, without the projections) is an `attn.core` span
(`netgen.telemetry`, live only while traced): `route` (flash, dense or
decode), `rows`, `q_len`, `kv_len`, `heads` and `kv_heads` (this
rank's), `head_dim`, and the (query block, key block) pairs computed
(`pairs`) and of those the pairs that hold a position the causal mask
keeps (`causal_pairs`); the dense and decode routes are one pair.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.layers import rotary
from repro_torch.layers.common import is_q, wx
from repro_torch.layers.flash import NEG_INF, block_pairs, flash_attention
from repro_torch.models.base import ArchConfig, ParamInfo
from repro_torch.netgen.telemetry import span
from repro_torch.parallel import tensor

__all__ = ["NEG_INF", "FLASH_MIN_SEQ", "attn_params", "init_cache_info", "attention"]

FLASH_MIN_SEQ = 2048   # dense path below this (smoke tests, short prompts)


def attn_params(cfg: ArchConfig, n_layers: int | None = None, d_in: int | None = None
                ) -> dict:
    """Abstract attention params; leading n_layers dim when stacked; the
    projections' input width `d_in` (d_model where None)."""
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    di = d if d_in is None else d_in
    L = () if n_layers is None else (n_layers,)
    nl = (None,) * len(L)
    fan = len(L)
    f32 = torch.float32
    p = {"wq": ParamInfo(L + (di, H, hd), f32, nl + ("fsdp", "heads", None), fan=fan),
         "wk": ParamInfo(L + (di, KV, hd), f32, nl + ("fsdp", "kv_heads", None), fan=fan),
         "wv": ParamInfo(L + (di, KV, hd), f32, nl + ("fsdp", "kv_heads", None), fan=fan),
         "wo": ParamInfo(L + (H, hd, d), f32, nl + ("heads", None, "fsdp"), fan=fan)}
    if cfg.qkv_bias:
        p["bq"] = ParamInfo(L + (H, hd), f32, nl + ("heads", None), init="zeros")
        p["bk"] = ParamInfo(L + (KV, hd), f32, nl + ("kv_heads", None), init="zeros")
        p["bv"] = ParamInfo(L + (KV, hd), f32, nl + ("kv_heads", None), init="zeros")
    return p


def init_cache_info(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Abstract KV cache for one attention site (stacked over sites by the
    caller), in the compute dtype; its sequence dim shards over the model
    axis (kv_seq)."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    logical = ("batch", "kv_heads", "kv_seq", None)
    return {"k": ParamInfo(shape, cfg.cdtype(), logical, init="zeros"),
            "v": ParamInfo(shape, cfg.cdtype(), logical, init="zeros")}


def _project(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """(B, S, D) x (D, H, hd) -> (B, S, H, hd) in compute dtype."""
    wm = wx(w, x.dtype)
    y = torch.matmul(x, wm.reshape(wm.shape[0], -1)).reshape(*x.shape[:2], *wm.shape[1:])
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _causal(S: int, T: int, device, q0: int = 0) -> torch.Tensor:
    """(S, T) bool: key index <= query index, the queries from position
    q0."""
    return torch.arange(T, device=device)[None, :] <= q0 + torch.arange(S, device=device)[:, None]


def _slots(n: int, first: int, device) -> torch.Tensor:
    """The positions of a cache's n slots, from `first`."""
    slots = torch.arange(n, device=device)
    return slots + first if first else slots


def _width(w) -> int:
    """Heads of a (D, heads, hd) projection leaf (its shard's, when split)."""
    return (w["q"] if is_q(w) else w).shape[-2]


def _kv_for(H: int, KV: int, first: int, n: int) -> tuple[int, int, list | None]:
    """The kv heads that query heads [first, first + n) use (h // (H/KV)):
    (first kv head, how many, None when the query heads group evenly
    over them, else each query head's index among them)."""
    rep = H // KV
    kvs = [h // rep for h in range(first, first + n)]
    k0, used = kvs[0], kvs[-1] - kvs[0] + 1
    if n % used == 0 and kvs == [k0 + i // (n // used) for i in range(n)]:
        return k0, used, None
    return k0, used, [k - k0 for k in kvs]


def attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,                       # (B, S, D)
    positions: torch.Tensor,               # (B, S) integer, or (3, B, S) for mrope
    *,
    cache: dict | None = None,             # {"k","v"} (B, KV, S_max, hd)
    cache_pos: torch.Tensor | None = None,  # (B,) write index for decode
    causal: bool = True,
    group=None,                            # the model group when p holds shards
    seq: tuple[int, int] | None = None,    # x's positions when split along the sequence
    scale: float | None = None,            # the scores' scale; hd^-1/2 where None
) -> tuple[torch.Tensor, dict | None]:
    """Returns (out (B, S, D), updated cache or None).

    With `group` (dense serving under a model axis above 1,
    `parallel/tensor.py`) p holds this rank's shards and the cache its
    slice: the local head counts are the shards' widths. Heads split:
    wq and wo are this rank's heads and rows, and one all-reduce sums
    the output; heads whole: both replicated, no reduction. kv heads
    split: wk, wv and the cache are this rank's kv heads. kv heads whole:
    wk and wv are replicated, the rank attends with the kv head(s) its
    query heads use, and the cache holds this rank's slice of positions:
    prefill writes that slice of the whole prompt's K/V; decode writes
    the new K/V where its position falls and combines each rank's
    partial attention over its positions by log-sum-exp in fp32 (the
    query heads gathered first when they are split).

    Gradients (training): where the heads split, x enters the projections
    through `copy_to`, which sums its gradient over the group, and `_out`
    sums the output with `reduce_from`. Where the kv heads stay whole
    under split query heads, k and v are projected from x itself and pass
    `copy_to` instead: each rank uses only its query heads' kv heads, so
    their gradients are summed there, once, and reach wk, wv, bk, bv and
    x whole on every rank. The flash path runs on the local heads.

    With x split along the sequence (`seq`: this rank's (first, count)
    positions, `tensor.seq_range`; `positions` stay the whole sequence's)
    the heads-split path gathers x (`tensor.gather_seq` in place of
    `copy_to`, k and v too where the kv heads stay whole) and `_out`
    reduce-scatters the output back to this rank's positions
    (`scatter_seq` in place of `reduce_from`). Where the heads stay
    whole, the reference splits the query sequence instead: q, k and v
    are projected from this rank's positions (RoPE at them), k and v are
    gathered along the sequence, the rank attends with its queries under
    a causal mask offset by its first position (flash too, chosen on the
    whole sequence's length, with query blocks that divide its count),
    and `wo` runs on its positions with no reduction. The cache is
    written from the gathered K/V as above. A rank's gradients of a
    replicated wq, wk, wv, wo and their biases are then its part of the
    whole, which the train step sums over the model group."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = hd ** -0.5 if scale is None else scale
    Hl, KVl, r = H, KV, 0
    if group is not None:
        Hl, KVl, r = _width(p["wq"]), _width(p["wk"]), dist.get_rank(group)
    heads_split = Hl < H
    by_seq = group is not None and cache is not None and KVl == KV
    h0 = r * Hl if heads_split else 0                # this rank's first query head
    q0 = 0                                           # the first query's position

    if seq is not None and heads_split:              # the whole sequence, by heads
        xs = tensor.gather_seq(x, group)
        S = xs.shape[1]
        q = _project(xs, p["wq"], p.get("bq"))
        k = _project(xs, p["wk"], p.get("bk"))
        v = _project(xs, p["wv"], p.get("bv"))
    elif seq is not None:                            # heads whole: the query sequence split
        q0 = seq[0]
        positions = positions.narrow(-1, q0, S)
        q = _project(x, p["wq"], p.get("bq"))
        k = _project(x, p["wk"], p.get("bk"))
        v = _project(x, p["wv"], p.get("bv"))
    else:
        xs = tensor.copy_to(x, group) if heads_split else x
        q = _project(xs, p["wq"], p.get("bq"))       # (B, S, Hl, hd)
        if heads_split and KVl == KV:                # whole kv heads: their gradient summed
            k = tensor.copy_to(_project(x, p["wk"], p.get("bk")), group)
            v = tensor.copy_to(_project(x, p["wv"], p.get("bv")), group)
        else:
            k = _project(xs, p["wk"], p.get("bk"))   # (B, S, KVl, hd)
            v = _project(xs, p["wv"], p.get("bv"))

    if cfg.pos == "rope":
        q = rotary.rope(q, positions, cfg.rope_theta)
        k = rotary.rope(k, positions, cfg.rope_theta)
    elif cfg.pos == "mrope":
        q = rotary.mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = rotary.mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    # cfg.pos == "sin": absolute embeddings added at the input; nothing here.
    if seq is not None and not heads_split:
        k, v = tensor.gather_seq(k, group), tensor.gather_seq(v, group)

    q = q.transpose(1, 2)                            # (B, Hl, S, hd)
    k = k.transpose(1, 2)                            # (B, KVl, T, hd)
    v = v.transpose(1, 2)
    T = k.shape[2]                                   # the whole sequence

    new_cache = None
    valid = None
    k_full, v_full, kv_len = k, v, T
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        first = r * ck.shape[2] if by_seq else 0     # the cache's first position
        if cache_pos is not None:
            # decode: write this step's K/V at each sequence's position
            if S != 1:
                raise ValueError("cache_pos decode expects S == 1")
            pos = cache_pos.long()
            at = (_slots(ck.shape[2], first, x.device)[None, None, :, None]
                  == pos[:, None, None, None])       # (B, 1, S_max, 1)
            ck = torch.where(at, k.to(ck.dtype), ck)
            cv = torch.where(at, v.to(cv.dtype), cv)
            k_full, v_full, kv_len = ck, cv, ck.shape[2]
            new_cache = {"k": ck, "v": cv}
            # attention mask: only positions <= cache_pos are valid
            valid = (_slots(kv_len, first, x.device)[None, None, None, :]
                     <= pos[:, None, None, None])    # (B, 1, 1, T)
            if by_seq:
                with span("attn.core", route="decode", rows=B, q_len=S, kv_len=kv_len,
                          heads=H, kv_heads=KV, head_dim=hd, pairs=1, causal_pairs=1):
                    ctx = _decode_by_seq(q, ck, cv, valid, group, heads_split, H, KV, h0, Hl,
                                         scale)
                return _out(p, ctx, x, group if heads_split else None), new_cache
        else:
            # prefill: the computed K/V (this rank's positions of them, when
            # the cache holds a slice) into a zeroed copy of the cache buffer
            ck = torch.zeros_like(ck)
            cv = torch.zeros_like(cv)
            if by_seq:
                n = max(0, min(T, first + ck.shape[2]) - first)
                ck[:, :, :n] = k[:, :, first:first + n].to(ck.dtype)
                cv[:, :, :n] = v[:, :, first:first + n].to(cv.dtype)
            else:
                ck[:, :, :T] = k.to(ck.dtype)
                cv[:, :, :T] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv}

    # the kv heads this rank's query heads use, relative to those it holds
    k0, used, gather = _kv_for(H, KV, h0, Hl)
    k0 -= r * KVl if KVl < KV else 0
    if used < k_full.shape[1]:
        k_full, v_full = k_full[:, k0:k0 + used], v_full[:, k0:k0 + used]
    if gather is not None:                           # uneven groups: one kv row a head
        idx = torch.tensor(gather, device=x.device)
        k_full, v_full, used = k_full[:, idx], v_full[:, idx], Hl

    Sq = q.shape[2]                                  # this rank's queries
    flash = valid is None and causal and T >= FLASH_MIN_SEQ
    q_blk = 512 if seq is None else math.gcd(512, Sq)
    pairs = block_pairs(Sq, T, q_blk, q_offset=q0) if flash else (1, 1)
    core = span("attn.core", route="flash" if flash else "dense" if valid is None else "decode",
                rows=B, q_len=Sq, kv_len=kv_len, heads=Hl, kv_heads=used, head_dim=hd,
                pairs=pairs[0], causal_pairs=pairs[1])
    if flash:
        # long-sequence path: flash-style chunked attention
        with core:
            ctx = flash_attention(q, k_full, v_full, causal=True, q_blk=q_blk, q_offset=q0,
                                  scale=scale)
    else:
        # grouped GQA: query heads reshaped (KV, rep); K/V in their stored layout
        with core:
            qg = q.reshape(B, used, Hl // used, Sq, hd)
            scores = torch.einsum("bgrsk,bgtk->bgrst", qg, k_full).float() * scale
            if valid is not None:
                scores = torch.where(valid[:, :, None], scores, NEG_INF)
            elif causal and T > 1:
                scores = torch.where(_causal(Sq, kv_len, x.device, q0), scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("bgrst,bgtk->bgrsk", probs, v_full).reshape(B, Hl, Sq, hd)
    if seq is not None and heads_split:
        return _out(p, ctx, x, group, scatter=True), new_cache
    return _out(p, ctx, x, group if heads_split else None), new_cache


def _decode_by_seq(q, ck, cv, valid, group, heads_split: bool, H: int, KV: int, h0: int,
                   Hl: int, scale: float) -> torch.Tensor:
    """One decode step's attention over a cache split by positions: every
    query head against this rank's positions, then the ranks' partial
    softmaxes combined by log-sum-exp (an all-reduce of the max, then one
    of the rescaled sums and contexts), in fp32. Returns this rank's
    heads' context (B, Hl, 1, hd) in q's dtype."""
    B, _, _, hd = q.shape
    if heads_split:
        q = tensor.all_gather(q, group, dim=1)       # (B, H, 1, hd)
    qg = q.reshape(B, KV, H // KV, 1, hd)
    scores = torch.einsum("bgrsk,bgtk->bgrst", qg, ck).float() * scale
    scores = torch.where(valid[:, :, None], scores, NEG_INF)            # (B, KV, rep, 1, T)
    top = tensor.all_reduce(scores.amax(dim=-1, keepdim=True), group, dist.ReduceOp.MAX)
    e = torch.exp(scores - top)
    part = torch.cat([torch.einsum("bgrst,bgtk->bgrsk", e, cv.float()),
                      e.sum(dim=-1, keepdim=True)], dim=-1)
    part = tensor.all_reduce(part, group)
    ctx = (part[..., :hd] / part[..., hd:]).to(q.dtype).reshape(B, H, 1, hd)
    return ctx[:, h0:h0 + Hl]


def _out(p: dict, ctx: torch.Tensor, x: torch.Tensor, group, scatter: bool = False
         ) -> torch.Tensor:
    """ctx (B, Hl, S, hd) through wo (this rank's rows), to wo's output
    width, summed over `group` when the heads are split: all-reduced, or
    with `scatter` reduce-scattered to this rank's positions of the
    sequence."""
    B, Hl, S, hd = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(B, S, Hl * hd)  # (B, S, Hl·hd)
    wo = wx(p["wo"], x.dtype)
    out = torch.matmul(ctx, wo.reshape(Hl * hd, wo.shape[-1]))
    if group is None:
        return out
    return tensor.scatter_seq(out, group) if scatter else tensor.reduce_from(out, group)
