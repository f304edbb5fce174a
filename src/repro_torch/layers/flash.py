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

A length that its blocks do not divide (a 4,092-token prompt against
blocks of 512 and 1,024) is zero-padded to whole blocks: the padded keys
are masked in the forward and in both backward passes, the padded
queries' rows are cut from the output (so their gradient is zero), and
the padding's own gradient is dropped. Lengths the blocks divide take no
padding and no extra mask. `scale` multiplies the scores (hd^-1/2 where
None).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "flash_attention", "block_pairs", "flash_attention_ref"]

NEG_INF = -2.0e38


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_blk: int = 512, k_blk: int = 1024,
                    q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k/v: (B, KV, T, hd) -> (B, H, S, hd); query i
    at key position q_offset + i; scores times `scale` (hd^-1/2 where
    None). S and T need not be multiples of the blocks."""
    S, T = q.shape[2], k.shape[2]
    q_blk = min(q_blk, S)
    k_blk = min(k_blk, T)
    if q_blk < 1 or k_blk < 1:
        raise ValueError(f"flash_attention needs blocks of at least 1, got q_blk={q_blk}, "
                         f"k_blk={k_blk}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_pad, k_pad = -S % q_blk, -T % k_blk
    if q_pad or k_pad:
        q = F.pad(q, (0, 0, 0, q_pad))
        k, v = F.pad(k, (0, 0, 0, k_pad)), F.pad(v, (0, 0, 0, k_pad))
    out = _Flash.apply(q, k, v, causal, q_blk, k_blk, q_offset, scale, T if k_pad else None)
    return out[:, :, :S] if q_pad else out


def block_pairs(S: int, T: int, q_blk: int = 512, k_blk: int = 1024, *,
                q_offset: int = 0) -> tuple[int, int]:
    """(block pairs `flash_attention` computes for S queries from position
    `q_offset` against T keys, those of them that hold a position its
    causal mask keeps)."""
    q_blk, k_blk = min(q_blk, S), min(k_blk, T)
    nq, nk = -(-S // q_blk), -(-T // k_blk)
    kept = sum(min(nk, (q_offset + min((i + 1) * q_blk, S) - 1) // k_blk + 1)
               for i in range(nq))
    return nq * nk, kept


def _mask(iq: int, jk: int, q_blk: int, k_blk: int, device, q0: int = 0,
          causal: bool = True, t_real: int | None = None) -> torch.Tensor:
    """(q_blk, k_blk) bool: key position <= query position (the queries
    from position q0) where `causal`, and key position < `t_real` (the
    keys before the padding) where given."""
    kpos = jk * k_blk + torch.arange(k_blk, device=device)[None, :]
    keep = None
    if causal:
        qpos = q0 + iq * q_blk + torch.arange(q_blk, device=device)[:, None]
        keep = kpos <= qpos
    if t_real is not None:
        real = kpos < t_real
        keep = real if keep is None else keep & real
    return keep


def _scores(qi, kj, scale, causal, iq, jk, q_blk, k_blk, q0=0, t_real=None) -> torch.Tensor:
    """(B, KV, rep, Q, K) fp32 scaled scores of one block pair, masked."""
    s = torch.einsum("bgrqd,bgkd->bgrqk", qi, kj).float() * scale
    if causal or t_real is not None:
        s = torch.where(_mask(iq, jk, q_blk, k_blk, s.device, q0, causal, t_real), s, NEG_INF)
    return s


def _flash_fwd(q, k, v, causal, q_blk, k_blk, q0, scale, t_real):
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
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
            s = _scores(qi, kj, scale, causal, iq, jk, q_blk, k_blk, q0, t_real)
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


def _flash_bwd(q, k, v, out, lse, dout, causal, q_blk, k_blk, q0, scale, t_real):
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    nq, nk = S // q_blk, T // k_blk
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
        p = torch.exp(_scores(qi, kj, scale, causal, iq, jk, q_blk, k_blk, q0, t_real)
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
    def forward(ctx, q, k, v, causal, q_blk, k_blk, q0, scale, t_real):
        out, lse = _flash_fwd(q, k, v, causal, q_blk, k_blk, q0, scale, t_real)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_blk, k_blk, q0, scale, t_real)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.blocks)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Dense oracle for tests (small shapes only)."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    kr = torch.repeat_interleave(k, H // KV, dim=1)
    vr = torch.repeat_interleave(v, H // KV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr).float() * (hd ** -0.5 if scale is None
                                                          else scale)
    if causal:
        qi = q_offset + torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(T, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr)
