"""Mamba2 mixer (SSD — state-space duality): prefill and decode paths.

Counterpart of `repro/layers/mamba2.py`. Block structure
(arXiv:2405.21060):
  in_proj: d -> [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
  causal conv1d (width 4) over [x, B, C]; silu
  SSD scan over chunks (the `ssd_scan` kernel / chunked plain version)
  gated RMSNorm: norm(y * silu(z)); out_proj: d_inner -> d

Decode keeps (conv_state (B, W-1, conv_dim), ssm_state (B, H, N, P)) and
advances the recurrence one token at a time. The reference's sharding
annotations (`shard`, `shard_hidden`, the `ssm_shard` flag) place
tensors on a mesh; on one card they are no-ops and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.common import wx
from repro_torch.models.base import ArchConfig, ParamInfo

__all__ = ["mamba_params", "ssm_cache_info", "mamba_mixer", "mamba_decode_step"]


def mamba_params(cfg: ArchConfig, n_layers: int | None = None) -> dict:
    d = cfg.d_model
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * G * N + H
    L = () if n_layers is None else (n_layers,)
    fan = len(L)
    f32 = torch.float32
    return {
        "in_proj": ParamInfo(L + (d, proj_out), f32, fan=fan),
        "conv_w": ParamInfo(L + (cfg.conv_width, cfg.conv_dim), f32, scale=0.5, fan=fan),
        "conv_b": ParamInfo(L + (cfg.conv_dim,), f32, init="zeros"),
        # A stored as log(-A): a = -exp(a_log); dt bias for softplus
        "a_log": ParamInfo(L + (H,), f32, init="zeros"),
        "dt_bias": ParamInfo(L + (H,), f32, init="zeros"),
        "d_skip": ParamInfo(L + (H,), f32, init="ones"),
        "norm_scale": ParamInfo(L + (di,), f32, init="ones"),
        "out_proj": ParamInfo(L + (di, d), f32, fan=fan),
    }


def ssm_cache_info(cfg: ArchConfig, batch: int) -> dict:
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    return {
        "conv": ParamInfo((batch, cfg.conv_width - 1, cfg.conv_dim), torch.float32,
                          init="zeros"),
        "ssm": ParamInfo((batch, H, N, P), torch.float32, init="zeros"),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    g = y * F.silu(z.float()).to(y.dtype)
    gf = g.float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * p["norm_scale"]).to(y.dtype)


def mamba_mixer(cfg: ArchConfig, p: dict, xin: torch.Tensor, *, chunk: int = 128,
                use_kernel: bool = False, return_state: bool = False):
    """Prefill path. xin: (B, S, D) -> (B, S, D). With return_state=True
    also returns the decode cache {conv, ssm} advanced through the whole
    sequence (used by prefill).

    use_kernel=True runs the SSD through `kernels.ssd_scan.ops.ssd` (the
    CUDA kernel on the card, its plain version on the CPU), with dt cast to
    the compute dtype first, as the reference's kernel route does. Unlike
    the reference, whose kernel route refuses S % chunk != 0, S is
    zero-padded to a chunk multiple first and y cut back: a padded row has
    dt = 0, so it adds nothing to y and leaves the state undecayed, and
    the result equals the unpadded scan."""
    B, S, D = xin.shape
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    dt_ = xin.dtype

    zxbcdt = torch.matmul(xin, wx(p["in_proj"], dt_))
    z, xbc_x, bmat, cmat, dt_raw = _split_proj(cfg, zxbcdt)

    # causal conv over [x, B, C] channels
    xbc = torch.cat([xbc_x, bmat, cmat], dim=-1)                  # (B, S, conv_dim)
    conv_w = p["conv_w"].to(dt_)                                   # (W, conv_dim)
    W = conv_w.shape[0]
    pads = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pads[:, i:i + S, :] * conv_w[i][None, None, :] for i in range(W))
    conv = conv + p["conv_b"].to(dt_)
    conv = F.silu(conv.float()).to(dt_)
    x, bmat, cmat = torch.split(conv, [di, G * N, G * N], dim=-1)

    xh = x.reshape(B, S, H, P)
    bh = bmat.reshape(B, S, G, N)
    ch = cmat.reshape(B, S, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # (B, S, H)
    a = -torch.exp(p["a_log"].float())                             # (H,)

    if use_kernel:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        dtk = dt.to(dt_)
        pad = -S % chunk
        if pad:
            xk, dtk, bk, ck = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                               for t in (xh, dtk, bh, ch))
        else:
            xk, bk, ck = xh, bh, ch
        y, s_fin = ssd_ops.ssd(xk, dtk, a, bk, ck, chunk=chunk)
        y = y[:, :S]
    else:
        y, s_fin = _ssd_chunked_batch(xh.float(), dt, a, bh.float(), ch.float(),
                                      chunk=chunk)
        y = y.to(dt_)
    y = y + xh * p["d_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = torch.matmul(y, wx(p["out_proj"], dt_))
    if not return_state:
        return out
    W = cfg.conv_width
    conv_state = xbc[:, S - (W - 1):, :].float()                   # (B, W-1, C)
    return out, {"conv": conv_state, "ssm": s_fin}


def _ssd_chunked_batch(x, dt, a, b, c, *, chunk: int):
    """Chunk-sequential SSD (fp32). x: (B,S,H,P); dt: (B,S,H); a: (H,);
    b/c: (B,S,G,N). Returns (y (B,S,H,P), s_final (B,H,N,P)). S is
    zero-padded to a chunk multiple (exact: padded rows have dt = 0), and
    the quadratic (Q x Q per head) tensors exist one chunk at a time."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    bh = b.repeat_interleave(rep, dim=2)                           # (B,S,H,N)
    ch = c.repeat_interleave(rep, dim=2)
    pad = -S % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bh = F.pad(bh, (0, 0, 0, 0, 0, pad))
        ch = F.pad(ch, (0, 0, 0, 0, 0, pad))
    Sp = x.shape[1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    s = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for q0 in range(0, Sp, chunk):
        xc, dc = x[:, q0:q0 + chunk], dt[:, q0:q0 + chunk]        # (B,Q,H,P) (B,Q,H)
        bc, cc = bh[:, q0:q0 + chunk], ch[:, q0:q0 + chunk]       # (B,Q,H,N)
        da = dc * a[None, None, :]
        cum = torch.cumsum(da, dim=1)
        lmat = torch.where(tri[None, :, :, None],
                           torch.exp(cum[:, :, None, :] - cum[:, None, :, :]),
                           torch.zeros((), device=x.device))
        scores = torch.einsum("bqhs,bkhs->bqkh", cc, bc) * lmat    # (B,Q,Q,H)
        y = torch.einsum("bqkh,bkhp->bqhp", scores, xc * dc[..., None])
        y = y + torch.einsum("bqhs,bhsp->bqhp", cc * torch.exp(cum)[..., None], s)
        decay_end = torch.exp(cum[:, -1:, :] - cum)                # (B,Q,H)
        s = s * torch.exp(cum[:, -1, :])[:, :, None, None] + torch.einsum(
            "bqhs,bqhp->bhsp", bc * (dc * decay_end)[..., None], xc)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y[:, :S], s


def mamba_decode_step(cfg: ArchConfig, p: dict, xin: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
    """Single-token decode. xin: (B, 1, D); cache: {conv (B,W-1,C), ssm
    (B,H,N,P)}. Returns (out (B, 1, D), new cache). O(1) in sequence."""
    B, S, D = xin.shape
    assert S == 1
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_headdim)
    dt_ = xin.dtype

    zxbcdt = torch.matmul(xin, wx(p["in_proj"], dt_))
    z, xbc_x, bmat, cmat, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xbc_x, bmat, cmat], dim=-1)[:, 0]             # (B, conv_dim)

    conv_state = cache["conv"].to(dt_)                             # (B, W-1, C)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)       # (B, W, C)
    conv_w = p["conv_w"].to(dt_)                                   # (W, C)
    conv = torch.einsum("bwc,wc->bc", window, conv_w) + p["conv_b"].to(dt_)
    conv = F.silu(conv.float()).to(dt_)
    new_conv_state = window[:, 1:, :]

    x, bmat, cmat = torch.split(conv, [di, G * N, G * N], dim=-1)
    xh = x.reshape(B, H, P).float()
    bh = bmat.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    ch = cmat.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])           # (B, H)
    a = -torch.exp(p["a_log"].float())

    s = cache["ssm"]                                               # (B,H,N,P) fp32
    decay = torch.exp(dt * a[None, :])                             # (B,H)
    s_new = s * decay[:, :, None, None] + torch.einsum("bhn,bh,bhp->bhnp", bh, dt, xh)
    y = torch.einsum("bhn,bhnp->bhp", ch, s_new)                   # (B,H,P)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(B, 1, di).to(dt_)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = torch.matmul(y, wx(p["out_proj"], dt_))
    return out, {"conv": new_conv_state.to(cache["conv"].dtype), "ssm": s_new}
