"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

Counterpart of `repro/kernels/ssd_scan/ref.py`. Semantics (per batch b,
head h; head dim P, state dim N):

    S_0 = S_init (or zeros)
    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t^T x_t        (N, P)
    y_t = C_t S_t                                              (P,)

with A_h < 0, dt_t > 0, and B/C shared across the heads of a group.

  * `ssd_sequential_ref` — the exact recurrence, step by step;
  * `ssd_chunked_ref`    — the chunked SSD algorithm (quadratic
    intra-chunk term + inter-chunk state recurrence) on one head;
  * `ssd_batched_ref`    — the chunked algorithm per (batch, head);
  * `ssd`                — the batched plain version with exactly
    `ops.ssd`'s contract, all (batch, head) pairs at once. The wrapper
    takes it for CPU tensors; `chip_smoke.py` holds the kernel to it.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_sequential_ref", "ssd_chunked_ref", "ssd_batched_ref", "ssd",
           "chunked_scan"]


def ssd_sequential_ref(x, dt, a, b, c, s_init=None):
    """x: (L, P); dt: (L,); a: scalar < 0; b, c: (L, N). Returns (y (L, P),
    s_final (N, P)). fp32 math."""
    x, dt, b, c = (t.float() for t in (x, dt, b, c))
    L, P = x.shape
    N = b.shape[-1]
    s = (torch.zeros((N, P), dtype=torch.float32, device=x.device)
         if s_init is None else s_init.float())
    a = torch.as_tensor(a, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        s = torch.exp(dt[t] * a) * s + dt[t] * (b[t, :, None] * x[t, None, :])
        ys.append(c[t] @ s)
    return torch.stack(ys) if ys else x.new_zeros((0, P)), s


def chunked_scan(x, dt, a, b, c, *, chunk: int, s_init=None):
    """The chunked SSD over a leading (batch*head) axis, in fp32.
    x: (BH, L, P); dt: (BH, L); a: (BH,); b, c: (BH, L, N); L % chunk == 0.
    Returns (y (BH, L, P), s_final (BH, N, P))."""
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    BH, L, P = x.shape
    N = b.shape[-1]
    assert L % chunk == 0, (L, chunk)
    s = (torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
         if s_init is None else s_init.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for q0 in range(0, L, chunk):
        xq, dtq = x[:, q0:q0 + chunk], dt[:, q0:q0 + chunk]
        bq, cq = b[:, q0:q0 + chunk], c[:, q0:q0 + chunk]
        cum = torch.cumsum(dtq * a[:, None], dim=1)                 # (BH, Q)
        # intra-chunk: masked decay matrix  L[t,s] = exp(cum_t - cum_s), t>=s
        lmat = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None, :]),
                           torch.zeros((), device=x.device))
        scores = torch.bmm(cq, bq.transpose(1, 2)) * lmat           # (BH, Q, Q)
        y = torch.bmm(scores, xq * dtq[..., None])
        # inter-chunk: contribution of the carried state
        y = y + torch.bmm(cq * torch.exp(cum)[..., None], s)
        ys.append(y)
        # state update: decay to the end of the chunk
        decay_to_end = torch.exp(cum[:, -1:] - cum)                 # (BH, Q)
        s = torch.exp(cum[:, -1])[:, None, None] * s + torch.bmm(
            (bq * (dtq * decay_to_end)[..., None]).transpose(1, 2), xq)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros((BH, 0, P))
    return y, s


def ssd_chunked_ref(x, dt, a, b, c, chunk: int = 64, s_init=None):
    """Chunked SSD, same signature/semantics as ssd_sequential_ref."""
    a = torch.as_tensor(a, dtype=torch.float32, device=x.device).reshape(1)
    y, s = chunked_scan(x[None], dt[None], a, b[None], c[None], chunk=chunk,
                        s_init=None if s_init is None else s_init[None])
    return y[0], s[0]


def ssd_batched_ref(x, dt, a_per_head, b, c, chunk: int = 64, s_init=None):
    """Per-(batch, head) oracle.
    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N), H % G == 0.
    Returns y (B, L, H, P), s_final (B, H, N, P)."""
    B, L, H, P = x.shape
    rep = H // b.shape[2]
    ys, ss = [], []
    for bi in range(B):
        yb, sb = [], []
        for hi in range(H):
            y, s = ssd_chunked_ref(
                x[bi, :, hi], dt[bi, :, hi], a_per_head[hi], b[bi, :, hi // rep],
                c[bi, :, hi // rep], chunk=chunk,
                s_init=None if s_init is None else s_init[bi, hi])
            yb.append(y)
            sb.append(s)
        ys.append(torch.stack(yb, dim=1))
        ss.append(torch.stack(sb, dim=0))
    return torch.stack(ys), torch.stack(ss)


def ssd(x, dt, a_per_head, b, c, *, chunk: int = 64):
    """`ops.ssd`'s contract on plain tensors: x (B, L, H, P), dt (B, L, H),
    a (H,), b/c (B, L, G, N). Flattens (B, H), repeats B/C over the heads
    of their group, runs the chunked scan in fp32. Returns (y (B, L, H, P)
    in x's dtype, contiguous as the kernel writes it, s_final (B, H, N, P)
    fp32)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    xf = x.permute(0, 2, 1, 3).reshape(B * H, L, P)
    dtf = dt.permute(0, 2, 1).reshape(B * H, L)
    af = a_per_head.float().repeat(B)
    bf = b.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(B * H, L, N)
    cf = c.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(B * H, L, N)
    y, s = chunked_scan(xf, dtf, af, bf, cf, chunk=chunk)
    y = y.reshape(B, H, L, P).permute(0, 2, 1, 3).to(x.dtype).contiguous()
    return y, s.reshape(B, H, N, P)
