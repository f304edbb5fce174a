"""Unified model API of the port: family dispatch + losses.

Counterpart of `repro/models/api.py`, with the same entry points:
  abstract_params(cfg)                  -> ParamInfo tree
  abstract_cache(cfg, batch, max_len)   -> ParamInfo tree (decode state)
  forward(cfg, params, batch)           -> (logits, aux)
  prefill(cfg, params, batch, cache)    -> (last_logits, cache)
  decode_step(cfg, params, tok, pos, c) -> (logits, cache)
Every LM family is ported: `dense` and `moe` (models/transformer.py),
`ssm` (models/mamba.py) and `hybrid` (models/zamba.py), in every
modality (`text`, `vlm`, `audio`). `forward` and `loss_fn` take the
reference's `remat` ("none" or "full": recompute each layer in the
backward pass); `prefill` serves and does not (the reference's takes it
and no caller sets it). All three take the port's `use_kernel`, which
sends every SSD of the `ssm` and `hybrid` families through the
`ssd_scan` kernel (it has no backward: training leaves it off); the
transformer families reach no kernel and ignore it.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba, transformer, zamba
from repro_torch.models.base import ArchConfig
from repro_torch.parallel import data_parallel as dp

__all__ = ["LB_WEIGHT", "Z_WEIGHT", "module_for", "abstract_params", "abstract_cache",
           "forward", "prefill", "decode_step", "loss_fn"]

_FAMILY = {"dense": transformer, "moe": transformer, "ssm": mamba, "hybrid": zamba}

LB_WEIGHT = 0.01
Z_WEIGHT = 1e-3


def module_for(cfg: ArchConfig):
    return _FAMILY[cfg.family]


def abstract_params(cfg: ArchConfig):
    return module_for(cfg).abstract_params(cfg)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int):
    return module_for(cfg).abstract_cache(cfg, batch, max_len)


def forward(cfg: ArchConfig, params, batch, *, remat: str = "none", use_kernel: bool = False):
    return module_for(cfg).forward(cfg, params, batch, remat=remat, use_kernel=use_kernel)


def prefill(cfg: ArchConfig, params, batch, cache, *, use_kernel: bool = False):
    return module_for(cfg).prefill(cfg, params, batch, cache, use_kernel=use_kernel)


def decode_step(cfg: ArchConfig, params, tokens, pos, cache, extras=None):
    return module_for(cfg).decode_step(cfg, params, tokens, pos, cache, extras)


def loss_fn(cfg: ArchConfig, params, batch, *, remat: str = "none", use_kernel: bool = False):
    """Next-token cross-entropy, plus the weighted auxiliary losses where
    `forward` returns any (every transformer: zeros for dense, the router's
    for MoE). Returns (loss, metrics), the aux losses among the metrics.
    Inside `data_parallel.reducing` (a data-parallel train step) the nll
    sum and the token count are the global batch's, reduced separately:
    the loss is the global batch's, and each rank's backward gives its
    rows' share of the gradient."""
    logits, aux = forward(cfg, params, batch, remat=remat, use_kernel=use_kernel)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    mask = mask.float()

    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)                               # (B, S)
    tgt = torch.take_along_dim(lf, targets[..., None].long(), dim=-1)[..., 0]
    nll = (lse - tgt) * mask
    # the global batch's sums inside a data-parallel train step
    denom = torch.clamp_min(dp.global_sum(mask.sum()), 1.0)
    loss = dp.global_sum(nll.sum()) / denom
    metrics = {"nll": loss}
    if aux:
        loss = loss + LB_WEIGHT * aux["lb_loss"] + Z_WEIGHT * aux["z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics
