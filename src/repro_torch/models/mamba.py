"""Mamba2 LM: embedding -> L x (norm -> SSD mixer) -> norm -> head.

Counterpart of `repro/models/mamba.py`. Parameters of the layers are
stacked on a leading (n_layers,) axis, as in the reference; its
`lax.scan` over them is a Python loop over the layers' slices
(`base.unstack`); the cache's slices are `base.layer`'s. `remat="full"`
recomputes each layer of `forward` in the backward pass
(`base.remat_call`). Attention-free: the decode state is O(1) in
sequence length.
"""
from __future__ import annotations

import torch

from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import mamba2 as m2
from repro_torch.layers import norms
from repro_torch.models.base import ArchConfig, ParamInfo, layer, remat_call, tree_map, unstack

__all__ = ["abstract_params", "abstract_cache", "layer_body", "backbone", "forward",
           "prefill", "decode_step", "layer"]


def abstract_params(cfg: ArchConfig) -> dict:
    L = cfg.n_layers
    return {
        "embed": emb_lib.embed_params(cfg),
        "layers": {
            "ln": norms.norm_params(cfg.norm, cfg.d_model, L),
            "mixer": m2.mamba_params(cfg, L),
        },
        "final_norm": norms.norm_params(cfg.norm, cfg.d_model),
    }


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    info = m2.ssm_cache_info(cfg, batch)
    return tree_map(lambda i: ParamInfo((cfg.n_layers,) + i.shape, i.dtype,
                                        (None,) + i.logical, init="zeros"), info)


def layer_body(cfg: ArchConfig, lp: dict, h: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """One Mamba2 layer (norm, mixer, residual) on layer slice `lp`; the
    hybrid family's mixers run it too."""
    hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
    return h + m2.mamba_mixer(cfg, lp["mixer"], hn, use_kernel=use_kernel)


def backbone(cfg: ArchConfig, params: dict, h: torch.Tensor, *, remat: str = "none",
             use_kernel: bool = False) -> torch.Tensor:
    for lp in unstack(params["layers"], cfg.n_layers):
        h = remat_call(remat, layer_body, cfg, lp, h, use_kernel)
    return norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: str = "none",
            use_kernel: bool = False) -> tuple[torch.Tensor, dict]:
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch)
    h = backbone(cfg, params, h, remat=remat, use_kernel=use_kernel)
    return emb_lib.lm_head(cfg, params["embed"], h), {}


def prefill(cfg: ArchConfig, params: dict, batch: dict, cache: dict, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, dict]:
    """Run the chunked scan over the prompt and build the decode state.
    Returns the last position's logits (B, V) and a cache advanced
    through the whole prompt (a new tree; `cache` gives the dtypes)."""
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch)
    convs, ssms = [], []
    for lp in unstack(params["layers"], cfg.n_layers):
        hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
        out, state = m2.mamba_mixer(cfg, lp["mixer"], hn, return_state=True,
                                    use_kernel=use_kernel)
        h = h + out
        convs.append(state["conv"].to(cache["conv"].dtype))
        ssms.append(state["ssm"].to(cache["ssm"].dtype))
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    logits = emb_lib.lm_head(cfg, params["embed"], h[:, -1:, :])[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cache: dict,
                extras: dict | None = None) -> tuple[torch.Tensor, dict]:
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch)
    convs, ssms = [], []
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
        out, new = m2.mamba_decode_step(cfg, lp["mixer"], hn, layer(cache, i))
        h = h + out
        convs.append(new["conv"])
        ssms.append(new["ssm"])
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    logits = emb_lib.lm_head(cfg, params["embed"], h)[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
