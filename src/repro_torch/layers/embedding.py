"""Token embedding, LM head and input assembly.

Counterpart of `repro/layers/embedding.py`: a separate head or tied
embeddings (no `head` leaf; the head is `tokᵀ`), gemma's embedding
scale, W8 leaves for both, and the backbone input of each modality
(`text`, `vlm`, `audio`), whose frontends are stubs that hand over
precomputed embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.layers import rotary
from repro_torch.layers.common import is_q
from repro_torch.models.base import ArchConfig, ParamInfo

__all__ = ["embed_params", "embed", "lm_head", "assemble_inputs"]


def embed_params(cfg: ArchConfig) -> dict:
    p = {"tok": ParamInfo((cfg.vocab, cfg.d_model), torch.float32, ("vocab", "fsdp"),
                          scale=1.0)}
    if not cfg.tie_embeddings:
        p["head"] = ParamInfo((cfg.d_model, cfg.vocab), torch.float32, ("fsdp", "vocab"))
    return p


def embed(cfg: ArchConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) in compute dtype."""
    tok = p["tok"]
    if is_q(tok):
        h = (tok["q"][tokens].float() * tok["s"]).to(cfg.cdtype())
    else:
        h = tok[tokens].to(cfg.cdtype())     # gather, then cast: the same values
    if cfg.scale_embedding:
        # the scale is rounded to h's dtype before the product, as in the
        # reference (sqrt(2048) = 45.2548... is 45.25 in bf16)
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    return h


def lm_head(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) -> logits (B, S, V) in h's dtype."""
    w = p["tok"] if cfg.tie_embeddings else p["head"]
    if is_q(w):
        if cfg.tie_embeddings:
            # w = q * s with per-d_model scales: fold s into h, matmul int8ᵀ
            return torch.matmul(h * w["s"].to(h.dtype), w["q"].to(h.dtype).T)
        return torch.matmul(h, (w["q"].float() * w["s"]).to(h.dtype))
    return torch.matmul(h, w.to(h.dtype).T if cfg.tie_embeddings else w.to(h.dtype))


def assemble_inputs(cfg: ArchConfig, p: dict, batch: dict) -> torch.Tensor:
    """Build the backbone input (B, S, D) per modality.

    text : embed(tokens)
    vlm  : embed(tokens) with the image positions (`pixel_mask`, (B, S)
           bool) overwritten by the stub frontend's patch embeddings
           (`pixel_embeds`, (B, S, D))
    audio: embed(tokens) plus the stub frontend's EnCodec frame
           embeddings (`frame_embeds`, (B, S, D)), plus sinusoidal
           positions (fp32, then cast) when `cfg.pos == "sin"`; the
           positions default to arange(S)
    """
    if cfg.modality == "text":
        return embed(cfg, p, batch["tokens"])
    if cfg.modality == "vlm":
        h = embed(cfg, p, batch["tokens"])
        pe = batch["pixel_embeds"].to(h.dtype)
        return torch.where(batch["pixel_mask"][:, :, None], pe, h)
    if cfg.modality == "audio":
        h = embed(cfg, p, batch["tokens"])
        h = h + batch["frame_embeds"].to(h.dtype)
        if cfg.pos == "sin":
            B, S = batch["tokens"].shape
            pos = batch.get("positions")
            if pos is None:
                pos = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
            h = h + rotary.sinusoidal_embedding(pos, cfg.d_model).to(h.dtype)
        return h
    raise ValueError(cfg.modality)
