"""Token embedding, LM head and input assembly.

Counterpart of `repro/layers/embedding.py`: a separate head or tied
embeddings (no `head` leaf; the head is `tokᵀ`), gemma's embedding
scale, W8 leaves for both, and the backbone input of each modality
(`text`, `vlm`, `audio`), whose frontends are stubs that hand over
precomputed embeddings.

Under a model axis above 1 (`group`, `parallel/tensor.py`) a vocab that
divides the axis is split: `tok` holds this rank's rows and `head` its
columns. The embedding gathers the ids in its rows, zeroes the others
and all-reduces (`reduce_from`: one non-zero term a position, so the sum
is exact; the backward hands each rank the whole gradient, which the
masked gather scatters into its own rows only), then applies gemma's
scale. The head takes h through `copy_to` (its gradient summed over the
group); serving all-gathers the local logits into the whole vocab
(`gather_from`), training keeps this rank's slice (`gather=False`) for
the vocab-split loss (`tensor.vocab_nll`). A tied head splits the same
`tok` leaf, whose gradient then sums the embedding's and the head's on
the same rows, as one process's does. A vocab that does not divide stays
whole.

With the hidden state split along the sequence between layers (`seq`,
this rank's (first, count) positions from `tensor.seq_range`; ROADMAP.md
A item 4), the split-vocab embedding looks up the whole sequence and
reduce-scatters it to this rank's positions (`tensor.scatter_seq` in
place of `reduce_from`), and a whole vocab looks up only this rank's
positions; `assemble_inputs` cuts the modality inputs to them. The
split-vocab head gathers the sequence first (`tensor.gather_seq` in
place of `copy_to`), so its logits cover every position; a whole vocab's
head runs on this rank's positions, and serving all-gathers its logits
along the sequence. A rank's gradient of a whole `tok` or `head` is then
its positions' part, which the train step sums over the model group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.layers import rotary
from repro_torch.layers.common import is_q
from repro_torch.models.base import ArchConfig, ParamInfo
from repro_torch.parallel import tensor

__all__ = ["embed_params", "embed", "lm_head", "assemble_inputs"]


def embed_params(cfg: ArchConfig) -> dict:
    p = {"tok": ParamInfo((cfg.vocab, cfg.d_model), torch.float32, ("vocab", "fsdp"),
                          scale=1.0)}
    if not cfg.tie_embeddings:
        p["head"] = ParamInfo((cfg.d_model, cfg.vocab), torch.float32, ("fsdp", "vocab"))
    return p


def embed(cfg: ArchConfig, p: dict, tokens: torch.Tensor, group=None, seq=None
          ) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) in compute dtype, or this rank's
    positions (B, S/m, D) when `seq` is given; `group` the model group
    when p holds shards."""
    tok = p["tok"]
    rows = (tok["q"] if is_q(tok) else tok).shape[0]
    if group is not None and rows < cfg.vocab:
        ids = tokens - dist.get_rank(group) * rows
        mine = (ids >= 0) & (ids < rows)
        h = _rows(cfg, tok, ids.clamp(0, rows - 1))
        h = torch.where(mine[..., None], h, torch.zeros_like(h))
        h = tensor.reduce_from(h, group) if seq is None else tensor.scatter_seq(h, group)
    else:
        h = _rows(cfg, tok, _positions(tokens, seq))
    if cfg.scale_embedding:
        # the scale is rounded to h's dtype before the product, as in the
        # reference (sqrt(2048) = 45.2548... is 45.25 in bf16)
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    return h


def _rows(cfg: ArchConfig, tok, ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows `ids` of `tok` (a tensor or a W8 leaf, whose
    per-d_model scales are whole) in compute dtype: gathered, then cast."""
    if is_q(tok):
        return (tok["q"][ids].float() * tok["s"]).to(cfg.cdtype())
    return tok[ids].to(cfg.cdtype())


def _positions(x: torch.Tensor, seq) -> torch.Tensor:
    """x's (B, S, ...) positions `seq` (first, count) along dim 1; x when
    `seq` is None."""
    return x if seq is None else x.narrow(1, seq[0], seq[1])


def lm_head(cfg: ArchConfig, p: dict, h: torch.Tensor, group=None, *,
            gather: bool = True, seq=None) -> torch.Tensor:
    """h (B, S, D) -> logits (B, S, V) in h's dtype; `group` the model
    group when p holds shards. With the vocab split, `gather=False` gives
    this rank's slice (B, S, V / m) instead of the whole vocab. `seq`: h
    holds this rank's positions of the sequence (B, S/m, D); the logits
    are then the whole sequence's, except with a whole vocab and
    `gather=False`, which gives this rank's positions (B, S/m, V)."""
    w = p["tok"] if cfg.tie_embeddings else p["head"]
    split = group is not None and (w["q"] if is_q(w) else w).shape[
        0 if cfg.tie_embeddings else 1] < cfg.vocab
    if split:
        h = tensor.copy_to(h, group) if seq is None else tensor.gather_seq(h, group)
    if is_q(w) and cfg.tie_embeddings:
        # w = q * s with per-d_model scales: fold s into h, matmul int8ᵀ
        logits = torch.matmul(h * w["s"].to(h.dtype), w["q"].to(h.dtype).T)
    elif is_q(w):
        logits = torch.matmul(h, (w["q"].float() * w["s"]).to(h.dtype))
    else:
        logits = torch.matmul(h, w.to(h.dtype).T if cfg.tie_embeddings else w.to(h.dtype))
    if split and gather:
        logits = tensor.gather_from(logits, group)
    elif seq is not None and not split and gather:
        logits = tensor.gather_from(logits, group, dim=1)
    return logits


def assemble_inputs(cfg: ArchConfig, p: dict, batch: dict, group=None, seq=None
                    ) -> torch.Tensor:
    """Build the backbone input (B, S, D) per modality.

    text : embed(tokens)
    vlm  : embed(tokens) with the image positions (`pixel_mask`, (B, S)
           bool) overwritten by the stub frontend's patch embeddings
           (`pixel_embeds`, (B, S, D))
    audio: embed(tokens) plus the stub frontend's EnCodec frame
           embeddings (`frame_embeds`, (B, S, D)), plus sinusoidal
           positions (fp32, then cast) when `cfg.pos == "sin"`; the
           positions default to arange(S)
    `group` and `seq` are the embedding's (`embed`): with `seq`, this
    rank's positions of each input.
    """
    if cfg.modality == "text":
        return embed(cfg, p, batch["tokens"], group, seq)
    if cfg.modality == "vlm":
        h = embed(cfg, p, batch["tokens"], group, seq)
        pe = _positions(batch["pixel_embeds"], seq).to(h.dtype)
        return torch.where(_positions(batch["pixel_mask"], seq)[:, :, None], pe, h)
    if cfg.modality == "audio":
        h = embed(cfg, p, batch["tokens"], group, seq)
        h = h + _positions(batch["frame_embeds"], seq).to(h.dtype)
        if cfg.pos == "sin":
            B, S = batch["tokens"].shape
            pos = batch.get("positions")
            if pos is None:
                pos = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
            h = h + rotary.sinusoidal_embedding(_positions(pos, seq), cfg.d_model).to(h.dtype)
        return h
    raise ValueError(cfg.modality)
