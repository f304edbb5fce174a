"""Flash-style chunked causal attention (online softmax) with a
memory-efficient backward, in plain PyTorch.

Counterpart of `repro/layers/flash.py`, which is plain JAX with a
`custom_vjp`; here the same two halves form a `torch.autograd.Function`:

  * forward: q/k tiles with running (max, sum, acc) carries — the standard
    FlashAttention recurrence; saves only (q, k, v, out, lse);
  * backward: two recomputation passes (dk/dv: outer loop over KV blocks;
    dq: outer loop over query blocks), no S^2 residuals.

The dtypes are the reference's: scores, the running max `m` and sum `l`
are fp32; the accumulator `acc` and the p·v products are in q's dtype.
GQA-aware: K/V stay (B, KV, T, hd) and query heads are grouped
(KV, rep), so expanded K/V never exist. As in the reference, every
(query block, key block) pair is computed, those the causal mask hides
entirely too. `q_offset` places the queries at positions [q_offset,
q_offset + S) of the keys' sequence, for a rank that attends with its
slice of the queries (the query-sequence split, `layers/attention.py`);
the causal mask reads it in the forward and in both backward passes.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention", "flash_attention_ref"]

NEG_INF = -2.0e38


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_blk: int = 512, k_blk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, S, hd); k/v: (B, KV, T, hd) -> (B, H, S, hd); query i
    at key position q_offset + i."""
    S, T = q.shape[2], k.shape[2]
    q_blk = min(q_blk, S)
    k_blk = min(k_blk, T)
    if S % q_blk or T % k_blk:
        raise ValueError(f"flash_attention needs S % q_blk == 0 and T % k_blk == 0, got "
                         f"S={S}, q_blk={q_blk}, T={T}, k_blk={k_blk}")
    return _Flash.apply(q, k, v, causal, q_blk, k_blk, q_offset)


def _mask(iq: int, jk: int, q_blk: int, k_blk: int, device, q0: int = 0) -> torch.Tensor:
    """(q_blk, k_blk) bool: key position <= query position (the queries
    from position q0)."""
    qpos = q0 + iq * q_blk + torch.arange(q_blk, device=device)[:, None]
    kpos = jk * k_blk + torch.arange(k_blk, device=device)[None, :]
    return kpos <= qpos


def _scores(qi, kj, scale, causal, iq, jk, q_blk, k_blk, q0=0) -> torch.Tensor:
    """(B, KV, rep, Q, K) fp32 scaled scores of one block pair, masked."""
    s = torch.einsum("bgrqd,bgkd->bgrqk", qi, kj).float() * scale
    if causal:
        s = torch.where(_mask(iq, jk, q_blk, k_blk, s.device, q0), s, NEG_INF)
    return s


def _flash_fwd(q, k, v, causal, q_blk, k_blk, q0=0):
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, rep, S, hd)
    outs, lses = [], []
    for iq in range(S // q_blk):
        qi = qg[:, :, :, iq * q_blk:(iq + 1) * q_blk]        # (B, KV, rep, Q, hd)
        acc = torch.zeros_like(qi)
        m = torch.full(qi.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(qi.shape[:-1], dtype=torch.float32, device=q.device)
        for jk in range(T // k_blk):
            kj = k[:, :, jk * k_blk:(jk + 1) * k_blk]
            vj = v[:, :, jk * k_blk:(jk + 1) * k_blk]
            s = _scores(qi, kj, scale, causal, iq, jk, q_blk, k_blk, q0)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bgkd->bgrqd", p.to(qi.dtype), vj)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append(acc / l[..., None].to(acc.dtype))
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=3).reshape(B, H, S, hd)
    return out, torch.cat(lses, dim=3)                       # lse: (B, KV, rep, S)


def _flash_bwd(q, k, v, out, lse, dout, causal, q_blk, k_blk, q0=0):
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    nq, nk = S // q_blk, T // k_blk
    scale = hd ** -0.5
    qg = q.reshape(B, KV, rep, S, hd)
    dog = dout.reshape(B, KV, rep, S, hd)
    # D_i = rowsum(dout * out)  (B, KV, rep, S)
    delta = torch.sum(dog.float() * out.reshape(B, KV, rep, S, hd).float(), dim=-1)

    def qblock(iq):
        sl = slice(iq * q_blk, (iq + 1) * q_blk)
        return qg[:, :, :, sl], dog[:, :, :, sl], lse[..., sl], delta[..., sl]

    def kblock(jk):
        sl = slice(jk * k_blk, (jk + 1) * k_blk)
        return k[:, :, sl], v[:, :, sl]

    def p_ds(qi, doi, lse_i, dl_i, kj, vj, iq, jk):
        p = torch.exp(_scores(qi, kj, scale, causal, iq, jk, q_blk, k_blk, q0)
                      - lse_i[..., None])
        dp = torch.einsum("bgrqd,bgkd->bgrqk", doi, vj).float()
        return p, p * (dp - dl_i[..., None]) * scale

    # ---- pass 1: dk/dv (outer over kv blocks, inner sums over q blocks)
    dks, dvs = [], []
    for jk in range(nk):
        kj, vj = kblock(jk)
        dk_j, dv_j = torch.zeros_like(kj), torch.zeros_like(vj)
        for iq in range(nq):
            qi, doi, lse_i, dl_i = qblock(iq)
            p, ds = p_ds(qi, doi, lse_i, dl_i, kj, vj, iq, jk)
            dv_j = dv_j + torch.einsum("bgrqk,bgrqd->bgkd", p.to(doi.dtype), doi)
            dk_j = dk_j + torch.einsum("bgrqk,bgrqd->bgkd", ds.to(qi.dtype), qi)
        dks.append(dk_j)
        dvs.append(dv_j)

    # ---- pass 2: dq (outer over q blocks, inner sums over kv blocks)
    dqs = []
    for iq in range(nq):
        qi, doi, lse_i, dl_i = qblock(iq)
        dq_i = torch.zeros_like(qi)
        for jk in range(nk):
            kj, vj = kblock(jk)
            _, ds = p_ds(qi, doi, lse_i, dl_i, kj, vj, iq, jk)
            dq_i = dq_i + torch.einsum("bgrqk,bgkd->bgrqd", ds.to(kj.dtype), kj)
        dqs.append(dq_i)
    dq = torch.cat(dqs, dim=3).reshape(B, H, S, hd)
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


class _Flash(torch.autograd.Function):
    """The forward recurrence, and the two-pass recomputation backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_blk, k_blk, q0):
        out, lse = _flash_fwd(q, k, v, causal, q_blk, k_blk, q0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_blk, k_blk, q0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.blocks)
        return dq, dk, dv, None, None, None, None


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Dense oracle for tests (small shapes only)."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    kr = torch.repeat_interleave(k, H // KV, dim=1)
    vr = torch.repeat_interleave(v, H // KV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr).float() * hd ** -0.5
    if causal:
        qi = q_offset + torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(T, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr)
