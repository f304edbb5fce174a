"""Rotary position embeddings: standard RoPE, multimodal M-RoPE (Qwen2-VL),
and sinusoidal absolute embeddings (MusicGen-style).

Counterpart of `repro/layers/rotary.py`. Angles and the rotation are
computed in fp32 and the result is cast back to x's dtype, as there.
"""
from __future__ import annotations

import torch

__all__ = ["rope", "mrope", "sinusoidal_embedding"]


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of x (B, S, H, hd) by the angles ang (B, S, hd/2)."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]                      # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE. x: (B, S, H, hd); positions: (B, S) integer."""
    freqs = _freqs(x.shape[-1], theta, x.device)             # (half,)
    return _rotate(x, positions[:, :, None].float() * freqs)


def mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions: (3, B, S) — (temporal, h, w)
    indices; `sections` are half-dim section lengths summing to hd//2.
    Each frequency band takes its angle from the section's position id."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim/2 = {half}")
    freqs = _freqs(x.shape[-1], theta, x.device)
    sec_id = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                     torch.tensor(sections, device=x.device),
                                     output_size=half)
    pos = positions.float()                                  # (3, B, S)
    ang = torch.zeros(pos.shape[1:] + (half,), dtype=torch.float32, device=x.device)
    for k in range(len(sections)):
        ang = torch.where(sec_id == k, pos[k][:, :, None] * freqs, ang)
    return _rotate(x, ang)


def sinusoidal_embedding(positions: torch.Tensor, d_model: int,
                         max_scale: float = 10_000.0) -> torch.Tensor:
    """Absolute sinusoidal embeddings. positions: (B, S) -> (B, S, D) fp32."""
    half = d_model // 2
    freqs = 1.0 / (max_scale ** (torch.arange(half, dtype=torch.float32,
                                              device=positions.device) / half))
    ang = positions[:, :, None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
