"""Plain float32 forward pass of the Mamba2 LM, and its count of work.

Written from the architecture's equations (arXiv:2405.21060: the Mamba2
mixer and its SSD), in plain PyTorch. It imports nothing of the program,
and it runs no cache: every position is computed from the tokens alone,
the whole sequence at once. It reads the benchmark's weights by their
paths (`weights.py`) and the sizes from the configuration file's `arch`
table. A configuration names this module by its `reference` key.

`logits(arch, w, tokens, last)` returns the float32 logits of the last
`last` positions. Inside it, TF32 is off for matmuls and convolutions, so
float32 means float32 on the card.

`precision="fp8"` is the control: the same pass with the operands of
every matrix product (the projections and the head) rounded to float8
e4m3, activations with a scale a row and weights with a scale an output
column, products accumulated in float32. It is the step below the
configuration's bfloat16 compute, and the check must tell it from the
program.

`prefill_flops(arch, rows, length)` is the model's work in one prefill
of `rows` prompts of `length` tokens: 2 operations for every weight of a
matrix product that a token passes through (every mixer's in_proj,
depthwise conv and out_proj), the head on the last position of each row
only, plus the SSD scan (`counts.ssd_forward`) in every mixer.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from gpubench import counts

__all__ = ["logits", "prefill_flops", "ssd", "fp8_round"]

_FP8_MAX = 448.0          # the largest finite float8 e4m3 (fn) value


@contextlib.contextmanager
def _fp32_exact():
    """TF32 off for matmuls and cuDNN convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for each slice along `dim`
    (the slice's largest magnitude maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = _FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


class _Ops:
    """The matrix products of one pass, exact float32 or the fp8 control."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N)."""
        if self.fp8:
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return torch.matmul(x, w)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for
    j <= i, -inf above the diagonal."""
    T = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, b, c, *, chunk: int = 64):
    """The SSD recurrence h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_tᵀ,
    y_t = C_t h_t, from a zero state, by its chunked dual form (all chunks
    at once; a chunk's state carried by the decay between chunk ends).
    x (R, T, H, P); dt (R, T, H); a (H,); b, c (R, T, G, N).
    Returns y (R, T, H, P) and the final state (R, H, N, P), float32."""
    R, T, H, P = x.shape
    G = b.shape[2]
    b = b.repeat_interleave(H // G, dim=2)
    c = c.repeat_interleave(H // G, dim=2)
    pad = -T % chunk
    if pad:            # dt = 0 rows: no input, no decay
        x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, b, c))
    n = x.shape[1] // chunk
    xs = (x * dt[..., None]).reshape(R, n, chunk, H, P)
    da = (dt * a).reshape(R, n, chunk, H).permute(0, 3, 1, 2)      # (R, H, n, Q)
    bs = b.reshape(R, n, chunk, H, -1)
    cs = c.reshape(R, n, chunk, H, -1)
    cum = torch.cumsum(da, dim=-1)
    decay = torch.exp(_segsum(da))                                  # (R, H, n, Q, Q)
    scores = torch.einsum("rclhn,rcshn->rhcls", cs, bs) * decay
    y = torch.einsum("rhcls,rcshp->rclhp", scores, xs)
    to_end = torch.exp(cum[..., -1:] - cum)                          # (R, H, n, Q)
    states = torch.einsum("rclhn,rhcl,rclhp->rchnp", bs, to_end, xs)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    between = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))       # (R, H, n+1, n+1)
    carried = torch.einsum("rhzc,rchnp->rzhnp", between, states)
    y = y + torch.einsum("rclhn,rchnp,rhcl->rclhp", cs, carried[:, :-1], torch.exp(cum))
    y = y.reshape(R, n * chunk, H, P)[:, :T]
    return y, carried[:, -1]


def _mixer(arch: dict, p: dict, x: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """The Mamba2 mixer on normed x (R, T, d)."""
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
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(R, T, H, P)
    y, _ = ssd(xh, dt, a, bm.reshape(R, T, G, N), cm.reshape(R, T, G, N))
    y = (y + xh * p["d_skip"][:, None]).reshape(R, T, di)
    g = _rms(y * F.silu(z), p["norm_scale"], arch["norm_eps"])
    return ops.mm(g, p["out_proj"])


def _layer(w: dict, i: int) -> dict:
    def take(node):
        return {k: take(v) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return take(w["layers"])


def logits(arch: dict, w: dict, tokens: torch.Tensor, last: int, *,
           precision: str = "fp32") -> torch.Tensor:
    """tokens (R, T) int -> float32 logits (R, last, vocab) of positions
    T - last .. T - 1 of the Mamba2 LM (`arch["family"]` "ssm")."""
    if arch["family"] != "ssm":
        raise ValueError(f"the Mamba2 reference does not run family {arch['family']!r}")
    ops = _Ops(precision)
    eps = arch["norm_eps"]
    with _fp32_exact(), torch.no_grad():
        h = w["embed"]["tok"][tokens].float()
        for i in range(arch["n_layers"]):
            lp = _layer(w, i)
            h = h + _mixer(arch, lp["mixer"], _rms(h, lp["ln"]["scale"], eps), ops)
        h = _rms(h[:, -last:], w["final_norm"]["scale"], eps)
        head = w["embed"]["tok"].t() if arch["tie_embeddings"] else w["embed"]["head"]
        return ops.mm(h, head)


def _mixer_weights(arch: dict) -> int:
    """Weights of one mixer's matrix products and conv a token passes."""
    d = arch["d_model"]
    H, P, N, G = counts.ssd_dims(arch)
    di = H * P
    conv_dim = di + 2 * G * N
    return d * (2 * di + 2 * G * N + H) + arch["conv_width"] * conv_dim + di * d


def prefill_flops(arch: dict, rows: int, length: int) -> float:
    """The model's operations in one prefill (see the module's docstring)."""
    L = arch["n_layers"]
    flops = 2.0 * rows * length * L * _mixer_weights(arch)
    flops += L * counts.ssd_forward(rows, length, *counts.ssd_dims(arch))[0]
    flops += 2.0 * rows * arch["d_model"] * arch["vocab"]
    return flops
