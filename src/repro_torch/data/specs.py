"""Storage-free stand-ins for every model input.

Counterpart of `repro/data/specs.py`. `input_specs(cfg, shape)` gives,
for each cell kind, the inputs as `meta` tensors (shape and dtype, no
allocation) made by `models.base.sds`, each with a `sharding`
attribute: its `NamedSharding` under an active mesh, None outside one:

  train   -> {tokens, targets, (+vlm/audio extras)}
  prefill -> {tokens, (+extras)}           (cache passed separately)
  decode  -> {tokens (B,1), pos (B,)}      (cache passed separately)
"""
from __future__ import annotations

import torch

from repro_torch.models.base import ArchConfig, ShapeConfig, sds

__all__ = ["input_specs"]


def _extras(cfg: ArchConfig, B: int, S: int, *, train: bool) -> dict:
    d = {}
    if cfg.modality == "vlm":
        d["pixel_embeds"] = sds((B, S, cfg.d_model), cfg.cdtype(), ("batch", "seq", None))
        d["pixel_mask"] = sds((B, S), torch.bool, ("batch", "seq"))
        # (B, 3, S): batch-leading so grad-accum microbatching can split
        d["positions"] = sds((B, 3, S), torch.int32, ("batch", None, "seq"))
        if train:
            d["loss_mask"] = sds((B, S), torch.float32, ("batch", "seq"))
    elif cfg.modality == "audio":
        d["frame_embeds"] = sds((B, S, cfg.d_model), cfg.cdtype(), ("batch", "seq", None))
    return d


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    if kind == "train":
        return {"tokens": sds((B, S), torch.int32, ("batch", "seq")),
                "targets": sds((B, S), torch.int32, ("batch", "seq")),
                **_extras(cfg, B, S, train=True)}
    if kind == "prefill":
        return {"tokens": sds((B, S), torch.int32, ("batch", "seq")),
                **_extras(cfg, B, S, train=False)}
    if kind == "decode":
        return {"tokens": sds((B, 1), torch.int32, ("batch", None)),
                "pos": sds((B,), torch.int32, ("batch",))}
    raise ValueError(kind)
