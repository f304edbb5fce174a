"""Multi-head attention with GQA/MQA, RoPE/M-RoPE, and a KV cache.

Counterpart of `repro/layers/attention.py` on one card (its logical
sharding annotations have no counterpart here). The cache layout is
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
"""
from __future__ import annotations

import torch

from repro_torch.layers import rotary
from repro_torch.layers.common import wx
from repro_torch.layers.flash import NEG_INF, flash_attention
from repro_torch.models.base import ArchConfig, ParamInfo

__all__ = ["NEG_INF", "FLASH_MIN_SEQ", "attn_params", "init_cache_info", "attention"]

FLASH_MIN_SEQ = 2048   # dense path below this (smoke tests, short prompts)


def attn_params(cfg: ArchConfig, n_layers: int | None = None) -> dict:
    """Abstract attention params; leading n_layers dim when stacked."""
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    L = () if n_layers is None else (n_layers,)
    fan = len(L)
    p = {"wq": ParamInfo(L + (d, H, hd), torch.float32, fan=fan),
         "wk": ParamInfo(L + (d, KV, hd), torch.float32, fan=fan),
         "wv": ParamInfo(L + (d, KV, hd), torch.float32, fan=fan),
         "wo": ParamInfo(L + (H, hd, d), torch.float32, fan=fan)}
    if cfg.qkv_bias:
        p["bq"] = ParamInfo(L + (H, hd), torch.float32, init="zeros")
        p["bk"] = ParamInfo(L + (KV, hd), torch.float32, init="zeros")
        p["bv"] = ParamInfo(L + (KV, hd), torch.float32, init="zeros")
    return p


def init_cache_info(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Abstract KV cache for one attention site (stacked over sites by the
    caller), in the compute dtype."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": ParamInfo(shape, cfg.cdtype(), init="zeros"),
            "v": ParamInfo(shape, cfg.cdtype(), init="zeros")}


def _project(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """(B, S, D) x (D, H, hd) -> (B, S, H, hd) in compute dtype."""
    wm = wx(w, x.dtype)
    y = torch.matmul(x, wm.reshape(wm.shape[0], -1)).reshape(*x.shape[:2], *wm.shape[1:])
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _causal(S: int, T: int, device) -> torch.Tensor:
    """(S, T) bool: key index <= query index."""
    return torch.arange(T, device=device)[None, :] <= torch.arange(S, device=device)[:, None]


def attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,                       # (B, S, D)
    positions: torch.Tensor,               # (B, S) integer, or (3, B, S) for mrope
    *,
    cache: dict | None = None,             # {"k","v"} (B, KV, S_max, hd)
    cache_pos: torch.Tensor | None = None,  # (B,) write index for decode
    causal: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (out (B, S, D), updated cache or None)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = _project(x, p["wq"], p.get("bq"))            # (B, S, H, hd)
    k = _project(x, p["wk"], p.get("bk"))            # (B, S, KV, hd)
    v = _project(x, p["wv"], p.get("bv"))

    if cfg.pos == "rope":
        q = rotary.rope(q, positions, cfg.rope_theta)
        k = rotary.rope(k, positions, cfg.rope_theta)
    elif cfg.pos == "mrope":
        q = rotary.mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = rotary.mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    # cfg.pos == "sin": absolute embeddings added at the input; nothing here.

    q = q.transpose(1, 2)                            # (B, H, S, hd)
    k = k.transpose(1, 2)                            # (B, KV, S, hd)
    v = v.transpose(1, 2)

    new_cache = None
    valid = None
    k_full, v_full, kv_len = k, v, S
    if cache is not None:
        if cache_pos is not None:
            # decode: write this step's K/V at each sequence's position
            if S != 1:
                raise ValueError("cache_pos decode expects S == 1")
            ck, cv = cache["k"], cache["v"]
            pos = cache_pos.long()
            at = (torch.arange(ck.shape[2], device=x.device)[None, None, :, None]
                  == pos[:, None, None, None])       # (B, 1, S_max, 1)
            ck = torch.where(at, k.to(ck.dtype), ck)
            cv = torch.where(at, v.to(cv.dtype), cv)
            k_full, v_full, kv_len = ck, cv, ck.shape[2]
            new_cache = {"k": ck, "v": cv}
            # attention mask: only positions <= cache_pos are valid
            valid = (torch.arange(kv_len, device=x.device)[None, None, None, :]
                     <= pos[:, None, None, None])    # (B, 1, 1, T)
        else:
            # prefill: the computed K/V into a zeroed copy of the cache buffer
            ck = torch.zeros_like(cache["k"])
            cv = torch.zeros_like(cache["v"])
            ck[:, :, :S] = k.to(ck.dtype)
            cv[:, :, :S] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv}

    scale = hd ** -0.5
    if valid is None and causal and S >= FLASH_MIN_SEQ:
        # long-sequence path: flash-style chunked attention
        ctx = flash_attention(q, k_full, v_full, causal=True)
    else:
        # grouped GQA: query heads reshaped (KV, rep); K/V in their stored layout
        qg = q.reshape(B, KV, H // KV, S, hd)
        scores = torch.einsum("bgrsk,bgtk->bgrst", qg, k_full).float() * scale
        if valid is not None:
            scores = torch.where(valid[:, :, None], scores, NEG_INF)
        elif causal and S > 1:
            scores = torch.where(_causal(S, kv_len, x.device), scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bgrst,bgtk->bgrsk", probs, v_full).reshape(B, H, S, hd)
    ctx = ctx.transpose(1, 2).reshape(B, S, H * hd)  # (B, S, H·hd)
    out = torch.matmul(ctx, wx(p["wo"], x.dtype).reshape(H * hd, D))
    return out, new_cache
