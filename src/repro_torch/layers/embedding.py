"""Token embedding, LM head and input assembly, for the `text` modality.

Counterpart of `repro/layers/embedding.py` for the ported families: a
separate head (`tie_embeddings` False) and no embedding scale. Tied
embeddings, gemma's scale and the `vlm` and `audio` modalities come
with their families (ROADMAP.md, A.10).
"""
from __future__ import annotations

import torch

from repro_torch.layers.common import is_q
from repro_torch.models.base import ArchConfig, ParamInfo

__all__ = ["embed_params", "embed", "lm_head", "assemble_inputs"]


def embed_params(cfg: ArchConfig) -> dict:
    if cfg.tie_embeddings or cfg.scale_embedding:
        raise NotImplementedError(
            "tied or scaled embeddings are not ported yet (ROADMAP.md, A.10)")
    return {"tok": ParamInfo((cfg.vocab, cfg.d_model), torch.float32, scale=1.0),
            "head": ParamInfo((cfg.d_model, cfg.vocab), torch.float32)}


def embed(cfg: ArchConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) in compute dtype."""
    tok = p["tok"]
    if is_q(tok):
        return (tok["q"][tokens].float() * tok["s"]).to(cfg.cdtype())
    return tok[tokens].to(cfg.cdtype())     # gather, then cast: the same values


def lm_head(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) -> logits (B, S, V) in h's dtype."""
    w = p["head"]
    if is_q(w):
        return torch.matmul(h, (w["q"].float() * w["s"]).to(h.dtype))
    return torch.matmul(h, w.to(h.dtype))


def assemble_inputs(cfg: ArchConfig, p: dict, batch: dict) -> torch.Tensor:
    """The backbone input (B, S, D): embed(tokens) for `text`."""
    if cfg.modality == "text":
        return embed(cfg, p, batch["tokens"])
    if cfg.modality in ("vlm", "audio"):
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported yet (ROADMAP.md, A.10: "
            "the transformer and hybrid families)")
    raise ValueError(cfg.modality)
