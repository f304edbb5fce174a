"""Unified model API of the port: family dispatch + losses.

Counterpart of `repro/models/api.py`, with the same entry points:
  abstract_params(cfg)                  -> ParamInfo tree
  abstract_cache(cfg, batch, max_len)   -> ParamInfo tree (decode state)
  forward(cfg, params, batch)           -> (logits, aux)
  prefill(cfg, params, batch, cache)    -> (last_logits, cache)
  decode_step(cfg, params, tok, pos, c) -> (logits, cache)
The `ssm` and `dense` families are ported; `moe` and `hybrid` raise
(ROADMAP.md, A.2 and A.3). `prefill` and `forward` take `use_kernel`,
which sends every SSD of the `ssm` family through the `ssd_scan`
kernel; the `dense` family reaches no kernel and ignores it.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba, transformer
from repro_torch.models.base import ArchConfig

__all__ = ["module_for", "abstract_params", "abstract_cache", "forward", "prefill",
           "decode_step", "loss_fn"]

_FAMILY = {"dense": transformer, "ssm": mamba}
_NOT_PORTED = {"moe": "A.3: the MoE family", "hybrid": "A.2: the hybrid family, zamba2"}


def module_for(cfg: ArchConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, {_NOT_PORTED[cfg.family]})")
    return _FAMILY[cfg.family]


def abstract_params(cfg: ArchConfig):
    return module_for(cfg).abstract_params(cfg)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int):
    return module_for(cfg).abstract_cache(cfg, batch, max_len)


def forward(cfg: ArchConfig, params, batch, *, use_kernel: bool = False):
    return module_for(cfg).forward(cfg, params, batch, use_kernel=use_kernel)


def prefill(cfg: ArchConfig, params, batch, cache, *, use_kernel: bool = False):
    return module_for(cfg).prefill(cfg, params, batch, cache, use_kernel=use_kernel)


def decode_step(cfg: ArchConfig, params, tokens, pos, cache, extras=None):
    return module_for(cfg).decode_step(cfg, params, tokens, pos, cache, extras)


def loss_fn(cfg: ArchConfig, params, batch, *, use_kernel: bool = False):
    """Next-token cross-entropy. Returns (loss, metrics). The MoE
    auxiliary losses come with that family (ROADMAP.md, A.3); the dense
    family's are zero."""
    logits, _ = forward(cfg, params, batch, use_kernel=use_kernel)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    mask = mask.float()

    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)                               # (B, S)
    tgt = torch.take_along_dim(lf, targets[..., None].long(), dim=-1)[..., 0]
    nll = (lse - tgt) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / denom
    return loss, {"nll": loss, "loss": loss}
