"""Plain float32 forward pass of Zamba2 (its published hybrid layout),
and its count of work.

Written from the published layer (transformers' `modeling_zamba2`, the
Zamba2 suite, arXiv:2411.15242) in plain PyTorch. It imports nothing of
the program and no kernel, and it runs no cache: every position is
computed from the tokens alone, the whole sequence at once. It reads the
benchmark's weights by their paths (`weights.py`) and the sizes from the
configuration file's `arch` table. A configuration names this module by
its `reference` key. With e the embedding output and h the residual
stream:

- Mamba layer i: h <- h + mixer_i(rms(h + t_i)), where t_i is the site's
  shared-block output at a layer of `hybrid_layer_ids` (site s) and 0
  elsewhere;
- the shared block b = s mod `num_mem_blocks` at site s, with no
  residual inside it: x = rms_2d(cat(h, e)); a = o_proj(attn(q_proj x,
  k_proj x, v_proj x)) with RoPE on q and k and the scale
  (head_dim / 2)^-1/2 (the published scaling of attention on the 2 d input);
  m = down(gelu(g) u), [g | u] = rms(a) W_gate_up + rms(a) A_s B_s;
  t_s = m L_s;
- the mixer: Mamba2 (in_proj to z | x | B | C | dt, causal conv with its
  bias and SiLU, the SSD, the D skip) with its gated RMSNorm taken over
  each group's d_inner / G channels (`group_size = intermediate_size //
  n_groups`), then out_proj;
- the final RMSNorm and the head, tied to the embedding.

`logits(arch, w, tokens, last)` returns the float32 logits of the last
`last` positions, TF32 off inside it. `precision="fp8"` is the control,
as in `reference/mamba2.py`: the operands of every matrix product of a
weight (the projections, the MLP, the adapters, the site linears and the
head) rounded to float8 e4m3; the attention's scores and the SSD stay
float32.

Departures from the published code, none of which changes the function
computed:

- weights are held in the benchmark's layout, x @ W (nn.Linear's
  transposes): q, k, v as (2 d, heads, head_dim), o as (heads, head_dim,
  d); the adapters A_s (d, rank), B_s (rank, 2 d_ff); the site linears
  (d, d);
- RoPE rotates the whole head by its halves (rotate_half), the rotated
  width the published configuration does not give;
- the SSD runs in its chunked dual form at chunk 64 (`reference/mamba2.py`
  `ssd`), where the published code takes chunk 256 and a kernel;
- the causal attention is dense, computed a row and a block of heads at a
  time so that no score tensor of a 4,096-token row takes more than
  a few hundred MB beside the weights.

`prefill_flops(arch, rows, length)`: 2 operations for every weight of a
matrix product that a token passes through (every mixer's in_proj,
depthwise conv and out_proj; at every site the attention's projections,
the MLP, the adapter and the site linear), the causal attention core
(4 · heads · head_dim · length (length + 1) / 2 a row at a site), the SSD
scan (`counts.ssd_forward`) in every mixer, and the head on the last
position of each row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench import counts
from gpubench.reference.mamba2 import _fp32_exact, _Ops, ssd

__all__ = ["logits", "prefill_flops"]

_HEAD_BLOCK = 8          # query heads a block of the dense attention


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (R, T, H, hd) rotated by its halves at positions 0 .. T - 1."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(arch: dict, p: dict, x: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """Causal multi-head attention of x (R, T, d_in) -> (R, T, d)."""
    R, T, _ = x.shape
    H, KV, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]

    def proj(w, n):
        return ops.mm(x, w.reshape(w.shape[0], -1)).reshape(R, T, n, hd)

    theta = arch["rope_theta"]
    q = _rope(proj(p["wq"], H), theta)
    k = _rope(proj(p["wk"], KV), theta).repeat_interleave(H // KV, dim=2)
    v = proj(p["wv"], KV).repeat_interleave(H // KV, dim=2)
    scale = (hd / 2) ** -0.5
    hidden = ~torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    ctx = torch.empty_like(q)
    for r in range(R):
        for h0 in range(0, H, _HEAD_BLOCK):
            hs = slice(h0, h0 + _HEAD_BLOCK)
            s = torch.einsum("thd,shd->hts", q[r, :, hs], k[r, :, hs]) * scale
            probs = torch.softmax(s.masked_fill_(hidden, float("-inf")), dim=-1)
            ctx[r, :, hs] = torch.einsum("hts,shd->thd", probs, v[r, :, hs])
    wo = p["wo"]
    return ops.mm(ctx.reshape(R, T, H * hd), wo.reshape(H * hd, wo.shape[-1]))


def _block(arch: dict, bp: dict, sp: dict, h: torch.Tensor, e: torch.Tensor,
           ops: _Ops) -> torch.Tensor:
    """The shared block at one site, through its adapter and linear."""
    eps = arch["norm_eps"]
    x = _rms(torch.cat([h, e], dim=-1), bp["ln_in"]["scale"], eps)
    y = _rms(_attention(arch, bp["attn"], x, ops), bp["ln_mlp"]["scale"], eps)
    gu = ops.mm(y, bp["mlp"]["gate_up"]) + ops.mm(ops.mm(y, sp["adapter_a"]), sp["adapter_b"])
    g, u = gu.chunk(2, dim=-1)
    m = ops.mm(F.gelu(g) * u, bp["mlp"]["down"])
    return ops.mm(m, sp["linear"])


def _mixer(arch: dict, p: dict, x: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """The Mamba2 mixer on normed x (R, T, d), its gated norm per group."""
    d = arch["d_model"]
    di = arch["ssm_expand"] * d
    N, G, P = arch["ssm_state"], arch["ssm_groups"], arch["ssm_headdim"]
    H = di // P
    R, T, _ = x.shape
    z, xbc, dt = torch.split(ops.mm(x, p["in_proj"]), [di, di + 2 * G * N, H], dim=-1)
    W = p["conv_w"].shape[0]
    conv = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :], p["conv_b"],
                    padding=W - 1, groups=xbc.shape[-1])[..., :T].transpose(1, 2)
    xs, bm, cm = torch.split(F.silu(conv), [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xs.reshape(R, T, H, P)
    y, _ = ssd(xh, dt, -torch.exp(p["a_log"]), bm.reshape(R, T, G, N), cm.reshape(R, T, G, N))
    y = (y + xh * p["d_skip"][:, None]).reshape(R, T, di)
    g = (y * F.silu(z)).reshape(R, T, G, di // G)
    g = (g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + arch["norm_eps"])).reshape(R, T, di)
    return ops.mm(g * p["norm_scale"], p["out_proj"])


def _slice(tree: dict, i: int) -> dict:
    return {k: _slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def logits(arch: dict, w: dict, tokens: torch.Tensor, last: int, *,
           precision: str = "fp32") -> torch.Tensor:
    """tokens (R, T) int -> float32 logits (R, last, vocab) of positions
    T - last .. T - 1 of Zamba2 (`arch["family"]` "hybrid" with
    `hybrid_layer_ids`)."""
    if arch["family"] != "hybrid" or not arch.get("hybrid_layer_ids"):
        raise ValueError(f"the Zamba2 reference runs the published hybrid layout, not "
                         f"family {arch['family']!r} without hybrid_layer_ids")
    ops = _Ops(precision)
    eps = arch["norm_eps"]
    sites = {i: s for s, i in enumerate(arch["hybrid_layer_ids"])}
    with _fp32_exact(), torch.no_grad():
        e = w["embed"]["tok"][tokens].float()
        h = e
        for i in range(arch["n_layers"]):
            x = h
            if i in sites:
                s = sites[i]
                x = h + _block(arch, _slice(w["blocks"], s % arch["num_mem_blocks"]),
                               _slice(w["sites"], s), h, e, ops)
            lp = _slice(w["layers"], i)
            h = h + _mixer(arch, lp["mixer"], _rms(x, lp["ln"]["scale"], eps), ops)
        h = _rms(h[:, -last:], w["final_norm"]["scale"], eps)
        head = w["embed"]["tok"].t() if arch["tie_embeddings"] else w["embed"]["head"]
        return ops.mm(h, head)


def prefill_flops(arch: dict, rows: int, length: int) -> float:
    """The model's operations in one prefill (see the module's docstring)."""
    d, f, r = arch["d_model"], arch["d_ff"], arch["adapter_rank"]
    H, KV, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    d_in = 2 * d
    Hs, P, N, G = counts.ssd_dims(arch)
    di = Hs * P
    mixer = d * (2 * di + 2 * G * N + Hs) + arch["conv_width"] * (di + 2 * G * N) + di * d
    site = d_in * (H + 2 * KV) * hd + H * hd * d + 3 * d * f + r * (d + 2 * f) + d * d
    L, n_sites, tokens = arch["n_layers"], len(arch["hybrid_layer_ids"]), rows * length
    flops = 2.0 * tokens * (L * mixer + n_sites * site)
    flops += n_sites * 4.0 * rows * H * hd * length * (length + 1) / 2
    flops += L * counts.ssd_forward(rows, length, Hs, P, N, G)[0]
    flops += 2.0 * rows * d * arch["vocab"]
    return flops
