"""Mamba2 mixer (SSD — state-space duality): prefill and decode paths.

Counterpart of `repro/layers/mamba2.py`. Block structure
(arXiv:2405.21060):
  in_proj: d -> [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
  causal conv1d (width 4) over [x, B, C]; silu
  SSD scan over chunks (the `ssd_scan` kernel / chunked plain version)
  gated RMSNorm: norm(y * silu(z)) over d_inner (over each group's
  d_inner / G with `ssm_group_norm`, Zamba2's); out_proj: d_inner -> d

Decode keeps (conv_state (B, W-1, conv_dim), ssm_state (B, H, N, P)) and
advances the recurrence one token at a time. The parameters and the
cache carry the reference's logical axes (`models.base.tree_specs`).
The reference's `ssm_shard` flag (`models.runtime.flag`, default
"mixed") is read by `parallel/tensor.py` `seq_splits`: in "mixed" the
hidden state between layers holds a rank's positions of the sequence
and the mixer runs by heads on the gathered sequence (`seq` below);
"heads" keeps it whole between mixers.

Under a model axis above 1 (`group`, `parallel/tensor.py`) the mixer
serves split by heads: its shards hold this rank's heads' columns of z,
x and dt, the B and C columns of the groups they use, those channels of
the conv and its cache, its heads' rows of `out_proj` and its heads of
the SSM cache; the whole per-head vectors are indexed at the rank's
heads. The SSD (the `ssd_scan` kernel or the chunked plain route) runs
on those heads and groups alone; the gated norm's mean over d_inner sums
its squares over the group (`tensor.sum_over`), and one all-reduce sums
the output (`reduce_from`). The split is read from the shards' shapes.
Gradients: the whole in_proj product takes `copy_to(xin)`, so xin's
gradient is the sum of every rank's share, B and C's included (each
rank's B and C gradient is its heads' part of the whole). A leaf that
a rank holds whole or shares with other ranks (the per-head vectors;
B and C's columns and conv channels where m > G) gets only this rank's
heads' part of its gradient: `sum_partial_grads` sums those over the
ranks that hold them, once a train step (`train/step.py`), and
`norm_weights` counts each shared B or C column once in the global
norm. With the hidden state split along the sequence (`seq`, ROADMAP.md
A item 4) the whole in_proj product takes `gather_seq(xin)` in place of
`copy_to(xin)` and the output is reduce-scattered back to the rank's
positions (`scatter_seq` in place of `reduce_from`); the conv, the SSD
(B7 at the same shapes as unsplit) and the gated norm's `sum_over` run
on the gathered sequence as before. A mixer that stays whole gathers
the sequence, runs whole and keeps its rank's positions, so its
gradients are its positions' part, which the train step sums.

The prefill conv, its bias and SiLU run as one pass of the `causal_conv`
kernel (`kernels/causal_conv`), which reads x|B|C in place from in_proj's
product, wherever the mixer can run it: on a CUDA device, with autograd
recording nothing of the conv; under the counting mode the kernel's call
counts its formula (`kernels/causal_conv/ops.py` `work`). Training, the
CPU and `meta` keep the composed conv (`kernels/causal_conv/ref.py`, after
a cat of x|B|C), so the dry run's counts are the aten ops' as before;
decode keeps its own.

Spans (`netgen.telemetry`, live only while traced), in prefill and
decode alike: `mixer.in_proj`, `mixer.conv` (prefill: the conv kernel,
`route="kernel"`, or the cat of x|B|C and the composed conv,
`route="plain"`; decode: the cat, the conv against the cached rows, its
bias and SiLU), `mixer.ssd` (the scan with its padding, or the decode
state update; the D skip), `mixer.gate_norm` and `mixer.out_proj`; the
projections' weight casts are `weights.cast` spans inside them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.causal_conv import ops as conv_ops
from repro_torch.kernels.causal_conv import ref as conv_ref
from repro_torch.layers.common import is_q, wx
from repro_torch.models.base import ArchConfig, ParamInfo
from repro_torch.netgen.telemetry import span
from repro_torch.parallel import tensor

__all__ = ["mamba_params", "ssm_cache_info", "mamba_mixer", "mamba_decode_step",
           "sum_partial_grads", "norm_weights"]

# the whole leaves the mixer indexes at its heads (width 1, or P a head)
_HEAD_VECTORS = ("a_log", "dt_bias", "d_skip", "norm_scale")
# the leaves that hold B and C (adjacent, G N each), and how many of the
# rank's x widths (d_inner on it) lie before them along the last dim
_BC_AT = {"in_proj": 2, "conv_w": 1, "conv_b": 1}


def mamba_params(cfg: ArchConfig, n_layers: int | None = None) -> dict:
    d = cfg.d_model
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * G * N + H
    P = cfg.ssm_headdim
    L = () if n_layers is None else (n_layers,)
    nl = (None,) * len(L)
    fan = len(L)
    f32 = torch.float32
    return {
        "in_proj": ParamInfo(L + (d, proj_out), f32, nl + ("fsdp", "ffn"), fan=fan,
                             segments=_segments(cfg, ("heads", P), ("heads", P), ("groups", N),
                                                ("groups", N), ("heads", 1))),
        "conv_w": ParamInfo(L + (cfg.conv_width, cfg.conv_dim), f32, nl + (None, "ffn"),
                            scale=0.5, fan=fan, segments=_conv_segments(cfg)),
        "conv_b": ParamInfo(L + (cfg.conv_dim,), f32, nl + ("ffn",), init="zeros",
                            segments=_conv_segments(cfg)),
        # A stored as log(-A): a = -exp(a_log); dt bias for softplus
        "a_log": ParamInfo(L + (H,), f32, nl + (None,), init="zeros"),
        "dt_bias": ParamInfo(L + (H,), f32, nl + (None,), init="zeros"),
        "d_skip": ParamInfo(L + (H,), f32, nl + (None,), init="ones"),
        "norm_scale": ParamInfo(L + (di,), f32, nl + (None,), init="ones"),
        "out_proj": ParamInfo(L + (di, d), f32, nl + ("ffn", "fsdp"), fan=fan,
                              segments=_segments(cfg, ("heads", P))),
    }


def _segments(cfg: ArchConfig, *segments) -> tuple:
    """`ParamInfo.segments`: the head-aligned cut of a leaf's "ffn" or
    "heads" dim (`parallel/tensor.py`)."""
    return (cfg.ssm_heads, cfg.ssm_groups, segments)


def _conv_segments(cfg: ArchConfig) -> tuple:
    N = cfg.ssm_state
    return _segments(cfg, ("heads", cfg.ssm_headdim), ("groups", N), ("groups", N))


def ssm_cache_info(cfg: ArchConfig, batch: int) -> dict:
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    return {
        "conv": ParamInfo((batch, cfg.conv_width - 1, cfg.conv_dim), torch.float32,
                          ("batch", None, "ffn"), init="zeros", segments=_conv_segments(cfg)),
        "ssm": ParamInfo((batch, H, N, P), torch.float32, ("batch", "heads", None, None),
                         init="zeros", segments=_segments(cfg, ("heads", 1))),
    }


@dataclasses.dataclass(frozen=True)
class _Local:
    """The mixer's widths on this rank (its shards'), its first head, and
    the model group when split (None: the whole mixer)."""
    di: int
    H: int
    G: int
    h0: int
    group: object


def _local(cfg: ArchConfig, p: dict, group) -> _Local:
    """Read the split from the shards' shapes: `out_proj`'s rows are the
    rank's heads, the conv's channels beyond them its groups' B and C."""
    w = p["out_proj"]
    di = (w["q"] if is_q(w) else w).shape[-2]
    if group is None or di == cfg.d_inner:
        return _Local(cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups, 0, None)
    H = di // cfg.ssm_headdim
    G = (p["conv_w"].shape[-1] - di) // (2 * cfg.ssm_state)
    return _Local(di, H, G, dist.get_rank(group) * H, group)


def _heads(loc: _Local, v: torch.Tensor, width: int = 1) -> torch.Tensor:
    """This rank's slice of a whole per-head vector (width entries a head)."""
    if loc.group is None:
        return v
    return v[..., loc.h0 * width:(loc.h0 + loc.H) * width]


def _shared_group(cfg: ArchConfig, loc: _Local) -> int | None:
    """The one group whose B and C this rank shares with the m/G - 1 other
    ranks whose heads use it (m > G), or None (each rank's groups are its
    own, or the mixer is whole)."""
    if loc.group is None or dist.get_world_size(loc.group) <= cfg.ssm_groups:
        return None
    return loc.h0 // (cfg.ssm_heads // cfg.ssm_groups)


def sum_partial_grads(cfg: ArchConfig, p: dict, grads: dict, group) -> tuple[str, ...]:
    """Complete in place the gradients that a split mixer's backward leaves
    partial: `grads` (the layer-stacked mixer leaves' gradients, leaf for
    leaf of `p`, the rank's shards). The per-head vectors are whole on
    every rank and each rank's gradient is its heads' part (zero
    elsewhere), so they are summed over `group`. Where m > G, the B and C
    columns of `in_proj` and channels of `conv_w` and `conv_b` are one
    group shared by m/G ranks, each holding its heads' part: each rank
    writes its part at its group's place in a zero tensor G groups wide,
    so that the sum over the whole group adds only the parts of the
    ranks that share a group, and takes its group's sum back. One
    all-reduce of all of it; nothing when the mixer is whole. Returns the
    names of the leaves it completed whole (the per-head vectors), or ()."""
    loc = _local(cfg, p, group)
    if loc.group is None:
        return ()
    G, N = cfg.ssm_groups, cfg.ssm_state
    g = _shared_group(cfg, loc)
    parts = [grads[k] for k in _HEAD_VECTORS]
    bcs = []
    if g is not None:
        for k, n in _BC_AT.items():
            bc = grads[k].narrow(-1, n * loc.di, 2 * N)
            wide = bc.new_zeros(bc.shape[:-1] + (2, G, N))
            wide[..., g, :] = bc.unflatten(-1, (2, N))
            parts.append(wide)
            bcs.append(bc)
    flat = torch.cat([t.reshape(-1) for t in parts])
    dist.all_reduce(flat, group=group)
    at = 0
    for i, t in enumerate(parts):
        got = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        if i < len(_HEAD_VECTORS):
            t.copy_(got)
        else:
            bcs[i - len(_HEAD_VECTORS)].copy_(got[..., g, :].flatten(-2))
    return _HEAD_VECTORS


def norm_weights(cfg: ArchConfig, p: dict, group) -> dict:
    """{leaf: 0/1 weights along its last dim} for a global norm over the
    rank's shards: where m > G, zero at the shared B and C on every rank
    but the first that holds the group, so each is counted once; {} on
    that rank and where nothing is shared."""
    loc = _local(cfg, p, group)
    if _shared_group(cfg, loc) is None:
        return {}
    if dist.get_rank(group) % (dist.get_world_size(group) // cfg.ssm_groups) == 0:
        return {}
    out = {}
    for k, n in _BC_AT.items():
        w = torch.ones(p[k].shape[-1], dtype=torch.float32, device=p[k].device)
        w[n * loc.di:n * loc.di + 2 * cfg.ssm_state] = 0
        out[k] = w
    return out


def _project(cfg: ArchConfig, p: dict, xin: torch.Tensor, loc: _Local, gathered: bool = False):
    """in_proj: (z, x, B, C, dt) at the rank's widths, from `copy_to(xin)`
    when split, or from xin itself when it was gathered along the
    sequence (see the module's docstring); and the product itself, whose
    x|B|C columns the conv kernel reads in place."""
    N = cfg.ssm_state
    with span("mixer.in_proj"):
        xs = xin if loc.group is None or gathered else tensor.copy_to(xin, loc.group)
        zxbcdt = torch.matmul(xs, wx(p["in_proj"], xin.dtype))
    parts = torch.split(zxbcdt, [loc.di, loc.di, loc.G * N, loc.G * N, loc.H], dim=-1)
    return (*parts, zxbcdt)


def _conv_on_card(x: torch.Tensor, p: dict) -> bool:
    """Whether the prefill conv runs the `causal_conv` kernel: x (a column
    block of in_proj's product) is on a CUDA device and autograd records
    nothing of the conv (the kernel has no backward)."""
    if not x.is_cuda:
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (x, p["conv_w"], p["conv_b"])))


def _gated_norm(cfg: ArchConfig, p, y: torch.Tensor, z: torch.Tensor, loc: _Local
                ) -> torch.Tensor:
    """norm(y * silu(z)) over the whole d_inner: split, each rank sums its
    channels' squares in fp32 and the sums are summed over the group.
    With `cfg.ssm_group_norm` (Zamba2's mixer) the norm is taken over
    each group's d_inner / G channels instead, on a whole mixer only."""
    with span("mixer.gate_norm"):
        g = y * F.silu(z.float()).to(y.dtype)
        gf = g.float()
        if cfg.ssm_group_norm:
            if loc.group is not None:
                raise ValueError("the per-group gated norm runs on a whole mixer only")
            gg = gf.unflatten(-1, (cfg.ssm_groups, -1))
            var = torch.mean(gg * gg, dim=-1, keepdim=True)
            gf = (gg * torch.rsqrt(var + cfg.norm_eps)).flatten(-2)
            return (gf * p["norm_scale"]).to(y.dtype)
        if loc.group is None:
            var = torch.mean(gf * gf, dim=-1, keepdim=True)
        else:
            var = tensor.sum_over(torch.sum(gf * gf, dim=-1, keepdim=True),
                                  loc.group) / cfg.d_inner
        scale = _heads(loc, p["norm_scale"], cfg.ssm_headdim)
        return (gf * torch.rsqrt(var + cfg.norm_eps) * scale).to(y.dtype)


def _out(p: dict, y: torch.Tensor, loc: _Local, seq=None) -> torch.Tensor:
    """out_proj, summed over the group when split: all-reduced, or with
    `seq` reduce-scattered to this rank's positions; a whole mixer on the
    gathered sequence keeps this rank's positions."""
    with span("mixer.out_proj"):
        out = torch.matmul(y, wx(p["out_proj"], y.dtype))
        if seq is not None:
            return out.narrow(1, *seq) if loc.group is None else tensor.scatter_seq(out, loc.group)
        return out if loc.group is None else tensor.reduce_from(out, loc.group)


def mamba_mixer(cfg: ArchConfig, p: dict, xin: torch.Tensor, *, chunk: int = 128,
                use_kernel: bool = False, return_state: bool = False, group=None, seq=None):
    """Prefill path. xin: (B, S, D) -> (B, S, D). With return_state=True
    also returns the decode cache {conv, ssm} advanced through the whole
    sequence (used by prefill). `group`: the model group when p holds
    this rank's shards (the cache returned is then its slice); `seq`:
    this rank's positions when xin holds them (B, S/m, D): the mixer
    gathers the sequence, runs on it and returns its positions.

    The conv (with its bias and SiLU) takes the `causal_conv` kernel on
    x|B|C in place where `_conv_on_card` allows, whatever `use_kernel`
    says; the composed conv elsewhere (see the module's docstring). Both
    give the conv state the decode cache keeps, x|B|C's last W - 1 rows.

    use_kernel=True runs the SSD through `kernels.ssd_scan.ops.ssd` (the
    CUDA kernel on the card, its plain version on the CPU), with dt cast to
    the compute dtype first, as the reference's kernel route does. Unlike
    the reference, whose kernel route refuses S % chunk != 0, S is
    zero-padded to a chunk multiple first and y cut back: a padded row has
    dt = 0, so it adds nothing to y and leaves the state undecayed, and
    the result equals the unpadded scan."""
    loc = _local(cfg, p, group)
    if seq is not None:                                            # the whole sequence
        xin = tensor.gather_seq(xin, group)
    B, S, D = xin.shape
    di, G, N, H, P = loc.di, loc.G, cfg.ssm_state, loc.H, cfg.ssm_headdim
    dt_ = xin.dtype

    z, xbc_x, bmat, cmat, dt_raw, zxbcdt = _project(cfg, p, xin, loc, seq is not None)

    # causal conv over [x, B, C] channels, its bias and SiLU
    on_card = _conv_on_card(xbc_x, p)
    with span("mixer.conv", route="kernel" if on_card else "plain"):
        if on_card:                                                # x|B|C in place
            xbc = zxbcdt.narrow(-1, di, di + 2 * G * N)
            conv = conv_ops.causal_conv(xbc, p["conv_w"], p["conv_b"])
        else:
            xbc = torch.cat([xbc_x, bmat, cmat], dim=-1)          # (B, S, conv_dim)
            conv = conv_ref.causal_conv(xbc, p["conv_w"], p["conv_b"])
    x, bmat, cmat = torch.split(conv, [di, G * N, G * N], dim=-1)

    xh = x.reshape(B, S, H, P)
    bh = bmat.reshape(B, S, G, N)
    ch = cmat.reshape(B, S, G, N)
    dt = F.softplus(dt_raw.float() + _heads(loc, p["dt_bias"]))    # (B, S, H)
    a = -torch.exp(_heads(loc, p["a_log"]).float())                # (H,)

    with span("mixer.ssd"):
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
        y = y + xh * _heads(loc, p["d_skip"]).to(dt_)[None, None, :, None]
    y = y.reshape(B, S, di)
    out = _out(p, _gated_norm(cfg, p, y, z, loc), loc, seq)
    if not return_state:
        return out
    W = cfg.conv_width
    conv_state = xbc[:, S - (W - 1):, :].float()                   # (B, W-1, C)
    return out, {"conv": conv_state, "ssm": s_fin}


def _ssd_chunked_batch(x, dt, a, b, c, *, chunk: int):
    """Chunk-sequential SSD (fp32). x: (B,S,H,P); dt: (B,S,H); a: (H,);
    b/c: (B,S,G,N). Returns (y (B,S,H,P), s_final (B,H,N,P)). S is
    zero-padded to a chunk multiple (exact: padded rows have dt = 0), and
    the quadratic (Q x Q per head) tensors exist one chunk at a time.
    The intra-chunk decay is masked before its exp, so its gradient stays
    finite where the decay over a chunk passes fp32's range (the
    reference's gives NaN there: ROADMAP.md C)."""
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
        # masked before the exp: above the diagonal cum_q - cum_k > 0 may
        # pass exp's fp32 range, and a mask after it would make the
        # gradient there 0 x inf = NaN (the reference masks after it)
        lmat = torch.exp((cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~tri[None, :, :, None], float("-inf")))
        scores = torch.einsum("bqhs,bkhs->bqkh", cc, bc) * lmat    # (B,Q,Q,H)
        y = torch.einsum("bqkh,bkhp->bqhp", scores, xc * dc[..., None])
        y = y + torch.einsum("bqhs,bhsp->bqhp", cc * torch.exp(cum)[..., None], s)
        decay_end = torch.exp(cum[:, -1:, :] - cum)                # (B,Q,H)
        s = s * torch.exp(cum[:, -1, :])[:, :, None, None] + torch.einsum(
            "bqhs,bqhp->bhsp", bc * (dc * decay_end)[..., None], xc)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y[:, :S], s


def mamba_decode_step(cfg: ArchConfig, p: dict, xin: torch.Tensor, cache: dict,
                      group=None) -> tuple[torch.Tensor, dict]:
    """Single-token decode. xin: (B, 1, D); cache: {conv (B,W-1,C), ssm
    (B,H,N,P)}. Returns (out (B, 1, D), new cache). O(1) in sequence.
    `group`: the model group when p holds shards and the cache its
    slice."""
    B, S, D = xin.shape
    assert S == 1
    loc = _local(cfg, p, group)
    di, G, N, H, P = loc.di, loc.G, cfg.ssm_state, loc.H, cfg.ssm_headdim
    dt_ = xin.dtype

    z, xbc_x, bmat, cmat, dt_raw, _ = _project(cfg, p, xin, loc)
    with span("mixer.conv"):
        xbc = torch.cat([xbc_x, bmat, cmat], dim=-1)[:, 0]         # (B, conv_dim)
        conv_state = cache["conv"].to(dt_)                         # (B, W-1, C)
        window = torch.cat([conv_state, xbc[:, None, :]], dim=1)   # (B, W, C)
        conv_w = p["conv_w"].to(dt_)                               # (W, C)
        conv = torch.einsum("bwc,wc->bc", window, conv_w) + p["conv_b"].to(dt_)
        conv = F.silu(conv.float()).to(dt_)
    new_conv_state = window[:, 1:, :]

    x, bmat, cmat = torch.split(conv, [di, G * N, G * N], dim=-1)
    xh = x.reshape(B, H, P).float()
    bh = bmat.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    ch = cmat.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    dt = F.softplus(dt_raw[:, 0].float() + _heads(loc, p["dt_bias"]))   # (B, H)
    a = -torch.exp(_heads(loc, p["a_log"]).float())

    with span("mixer.ssd"):
        s = cache["ssm"]                                           # (B,H,N,P) fp32
        decay = torch.exp(dt * a[None, :])                         # (B,H)
        s_new = s * decay[:, :, None, None] + torch.einsum("bhn,bh,bhp->bhnp", bh, dt, xh)
        y = torch.einsum("bhn,bhnp->bhp", ch, s_new)               # (B,H,P)
        y = y + xh * _heads(loc, p["d_skip"])[None, :, None]
        y = y.reshape(B, 1, di).to(dt_)
    out = _out(p, _gated_norm(cfg, p, y, z, loc), loc)
    return out, {"conv": new_conv_state.to(cache["conv"].dtype), "ssm": s_new}
