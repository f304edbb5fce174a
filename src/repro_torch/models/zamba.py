"""Zamba2-style hybrid: a Mamba2 backbone with a SHARED attention+MLP
block applied every `attn_every` layers (arXiv:2411.15242).

Counterpart of `repro/models/zamba.py`. The shared block has one set of
weights, reused at every application site; its input is the
concatenation of the current hidden state with the original embedding,
brought back to d_model by one learned projection. The per-site LoRA
adapters of the paper are omitted, as in the reference.

Structure: n_layers Mamba2 layers in groups of `attn_every`; after each
group the shared block runs. The reference's `lax.scan` over each group
is a Python loop over the layers' slices (`base.unstack`), as in
`models/mamba.py`; `remat="full"` recomputes each Mamba2 layer of
`forward` in the backward pass, as the reference remats the group's scan
body and not the shared block. The decode state is the SSM cache
stacked over all layers and the KV cache stacked over the n_layers /
attn_every sites.

`use_kernel` sends every mixer's SSD through the `ssd_scan` kernel, as
in `models/mamba.py`; the reference's zamba never passes it, and the
port's kernel route is held to the plain route (`chip_smoke.py`).
"""
from __future__ import annotations

import torch

from repro_torch.layers import attention as attn_lib
from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import mamba2 as m2
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import norms
from repro_torch.layers.common import wx
from repro_torch.models.base import ArchConfig, ParamInfo, layer, remat_call, tree_map, unstack
from repro_torch.models.mamba import layer_body

__all__ = ["n_sites", "abstract_params", "abstract_cache", "forward", "prefill",
           "decode_step"]


def n_sites(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def abstract_params(cfg: ArchConfig) -> dict:
    L = cfg.n_layers
    return {
        "embed": emb_lib.embed_params(cfg),
        "layers": {
            "ln": norms.norm_params(cfg.norm, cfg.d_model, L),
            "mixer": m2.mamba_params(cfg, L),
        },
        "shared": {
            "in_proj": ParamInfo((2 * cfg.d_model, cfg.d_model), torch.float32,
                                 ("fsdp", None)),
            "ln_attn": norms.norm_params(cfg.norm, cfg.d_model),
            "attn": attn_lib.attn_params(cfg),
            "ln_mlp": norms.norm_params(cfg.norm, cfg.d_model),
            "mlp": mlp_lib.mlp_params(cfg),
        },
        "final_norm": norms.norm_params(cfg.norm, cfg.d_model),
    }


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """SSM cache stacked over layers + KV cache stacked over shared sites."""
    def stack(n):
        return lambda i: ParamInfo((n,) + i.shape, i.dtype, (None,) + i.logical,
                                   init="zeros")

    return {"ssm": tree_map(stack(cfg.n_layers), m2.ssm_cache_info(cfg, batch)),
            "kv": tree_map(stack(n_sites(cfg)), attn_lib.init_cache_info(cfg, batch, max_len))}


def _groups(cfg: ArchConfig):
    """Layer indices of each group of `attn_every` mixers, one group a site."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.attn_every}")
    k = cfg.attn_every
    return [range(g * k, (g + 1) * k) for g in range(n_sites(cfg))]


def _shared_block(cfg: ArchConfig, sp: dict, h, emb0, positions, cache_kv, cache_pos):
    """The shared attention+MLP block. Returns (h, new_kv_cache)."""
    x = torch.matmul(torch.cat([h, emb0], dim=-1), wx(sp["in_proj"], h.dtype))
    xn = norms.apply_norm(cfg.norm, sp["ln_attn"], x, eps=cfg.norm_eps)
    a, new_kv = attn_lib.attention(cfg, sp["attn"], xn, positions, cache=cache_kv,
                                   cache_pos=cache_pos)
    x = x + a
    xn = norms.apply_norm(cfg.norm, sp["ln_mlp"], x, eps=cfg.norm_eps)
    x = x + mlp_lib.mlp(cfg, sp["mlp"], xn)
    return h + x, new_kv


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: str = "none",
            use_kernel: bool = False) -> tuple[torch.Tensor, dict]:
    B, S = batch["tokens"].shape
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch)
    emb0, positions = h, _positions(B, S, h.device)
    layers = unstack(params["layers"], cfg.n_layers)
    for group in _groups(cfg):
        for i in group:
            h = remat_call(remat, layer_body, cfg, layers[i], h, use_kernel)
        h, _ = _shared_block(cfg, params["shared"], h, emb0, positions, None, None)
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    return emb_lib.lm_head(cfg, params["embed"], h), {}


def prefill(cfg: ArchConfig, params: dict, batch: dict, cache: dict, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, dict]:
    """Run the prompt, filling each site's KV cache and building every
    layer's SSM state (cast to the cache's dtypes). Returns the last
    position's logits (B, V) and the new cache."""
    B, S = batch["tokens"].shape
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch)
    emb0, positions = h, _positions(B, S, h.device)
    convs, ssms, ks, vs = [], [], [], []
    layers = unstack(params["layers"], cfg.n_layers)
    for g, group in enumerate(_groups(cfg)):
        for i in group:
            lp = layers[i]
            hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
            out, state = m2.mamba_mixer(cfg, lp["mixer"], hn, return_state=True,
                                        use_kernel=use_kernel)
            h = h + out
            convs.append(state["conv"].to(cache["ssm"]["conv"].dtype))
            ssms.append(state["ssm"].to(cache["ssm"]["ssm"].dtype))
        h, kv = _shared_block(cfg, params["shared"], h, emb0, positions,
                              layer(cache["kv"], g), None)
        ks.append(kv["k"])
        vs.append(kv["v"])
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    logits = emb_lib.lm_head(cfg, params["embed"], h[:, -1:, :])[:, 0]
    return logits, {"ssm": {"conv": torch.stack(convs), "ssm": torch.stack(ssms)},
                    "kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cache: dict,
                extras: dict | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1); pos: (B,) current write index.
    Returns (logits (B, V), new cache)."""
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch)
    emb0, positions = h, pos[:, None]
    convs, ssms, ks, vs = [], [], [], []
    layers = unstack(params["layers"], cfg.n_layers)
    for g, group in enumerate(_groups(cfg)):
        for i in group:
            lp = layers[i]
            hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
            out, new = m2.mamba_decode_step(cfg, lp["mixer"], hn, layer(cache["ssm"], i))
            h = h + out
            convs.append(new["conv"])
            ssms.append(new["ssm"])
        h, kv = _shared_block(cfg, params["shared"], h, emb0, positions,
                              layer(cache["kv"], g), pos)
        ks.append(kv["k"])
        vs.append(kv["v"])
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    logits = emb_lib.lm_head(cfg, params["embed"], h)[:, 0]
    return logits, {"ssm": {"conv": torch.stack(convs), "ssm": torch.stack(ssms)},
                    "kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
