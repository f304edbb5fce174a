"""Decoder-only transformer: dense (qwen/llama/gemma/musicgen), MoE
(granite/qwen3-moe), VLM backbone (qwen2-vl) — one implementation,
config-switched.

Counterpart of `repro/models/transformer.py`. Parameters of the layers are
stacked on a leading (n_layers,) axis, as in the reference; its
`lax.scan` over them is a Python loop over the layers' slices
(`base.unstack`); the KV cache's slices are `base.layer`'s. `remat="full"`
recomputes each block of `forward` in the backward pass
(`base.remat_call`). A MoE block's feed-forward is `layers/moe.py`;
its auxiliary losses are summed over the layers and divided by their
number, and a dense model's are zero, as in the reference. gemma's
(1 + w) norm scale is the config's `norm_plus_one` field, where the
reference tests the config's name, so a renamed or derived config keeps
it.

Under a model axis above 1 the dense and MoE families run their split
layers on parameter shards with the model group (`tensor.group_for`;
`parallel/tensor.py`): `prefill` and `decode_step` with a cache slice
(`local_tree`, `cache_len`; ROADMAP.md A.7a, A.7d), and `forward`, which
training runs (A.7b, A.7d), with the layers' autograd collectives; its
`local_vocab=True` keeps the head's logits split over the vocab for
`api.loss_fn`. A MoE block runs its experts' shards (`layers/moe.py`,
expert parallelism: the routing replicated over the group, one
all-reduce of the partial output). A train state cut over "data" too
(FSDP, `parallel/fsdp.py`) is gathered a layer at a time inside the
function that `remat_call` checkpoints (the attention's, the norms' and
the MoE block's router and expert leaves alike), so the recompute
gathers again; the embedding's leaves are gathered where `forward`
uses them. Where the sequence divides the model group, `forward` and
`prefill` carry the hidden state split along it between layers
(`tensor.seq_range`, ROADMAP.md A item 4): each block's input, and so
what `remat_call` saves, is (B, S/m, D), the positions stay the whole
sequence's, and the recompute gathers again in the same order on every
rank; `prefill` brings the last position to every rank before the head
(`tensor.last_row`). A decode step keeps it whole (recorded).

`forward` and `prefill` take the port's `use_kernel` keyword, which the
`Engine` passes to every family: the transformer path reaches no kernel,
as the reference's reaches no Pallas kernel, so it has no effect here.
"""
from __future__ import annotations

import torch

from repro_torch.layers import attention as attn_lib
from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import norms
from repro_torch.models.base import ArchConfig, ParamInfo, layer, remat_call, tree_map, unstack
from repro_torch.parallel import fsdp, tensor

__all__ = ["abstract_params", "abstract_cache", "backbone", "forward", "prefill",
           "decode_step"]


def abstract_params(cfg: ArchConfig) -> dict:
    L = cfg.n_layers
    plus_one = cfg.norm_plus_one
    p = {
        "embed": emb_lib.embed_params(cfg),
        "layers": {
            "ln_attn": norms.norm_params(cfg.norm, cfg.d_model, L, plus_one=plus_one),
            "attn": attn_lib.attn_params(cfg, L),
            "ln_mlp": norms.norm_params(cfg.norm, cfg.d_model, L, plus_one=plus_one),
        },
        "final_norm": norms.norm_params(cfg.norm, cfg.d_model, plus_one=plus_one),
    }
    if cfg.family == "moe":
        p["layers"]["moe"] = moe_lib.moe_params(cfg, L)
    else:
        p["layers"]["mlp"] = mlp_lib.mlp_params(cfg, L)
    return p


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """KV cache stacked over layers: (L, B, KV, S, hd)."""
    info = attn_lib.init_cache_info(cfg, batch, max_len)
    return tree_map(lambda i: ParamInfo((cfg.n_layers,) + i.shape, i.dtype,
                                        (None,) + i.logical, init="zeros"), info)


def _block(cfg: ArchConfig, lp: dict, h, positions, cache_layer, cache_pos, causal: bool,
           group=None, dims=None, seq=None):
    """One transformer block. Returns (h, new_cache_layer, aux). `dims`:
    the fsdp dims of lp's shards, gathered here (`fsdp.gather_tree`);
    `seq`: h's positions when it holds this rank's of the sequence."""
    lp = fsdp.gather_tree(lp, dims)
    plus_one = cfg.norm_plus_one
    hn = norms.apply_norm(cfg.norm, lp["ln_attn"], h, eps=cfg.norm_eps, plus_one=plus_one)
    a, new_cache = attn_lib.attention(cfg, lp["attn"], hn, positions, cache=cache_layer,
                                      cache_pos=cache_pos, causal=causal, group=group,
                                      seq=seq)
    h = h + a
    hn = norms.apply_norm(cfg.norm, lp["ln_mlp"], h, eps=cfg.norm_eps, plus_one=plus_one)
    if cfg.family == "moe":
        m, aux = moe_lib.moe(cfg, lp["moe"], hn, group=group, seq=seq)
    else:
        m, aux = mlp_lib.mlp(cfg, lp["mlp"], hn, group, seq), None
    return h + m, new_cache, aux


def backbone(cfg: ArchConfig, params: dict, h: torch.Tensor, positions: torch.Tensor, *,
             cache: dict | None = None, cache_pos: torch.Tensor | None = None,
             remat: str = "none", group=None, dims: dict | None = None,
             seq=None) -> tuple[torch.Tensor, dict | None, dict]:
    """Run all layers. Returns (h, new_cache, aux_losses): the MoE losses
    averaged over the layers; a dense model's are zero, as in the reference.
    `group`: the model group when `params` are shards (`_block`); `dims`:
    `fsdp.shard_dims` of `params`, whose layer shards each block gathers;
    `seq`: h's positions (`tensor.seq_range`) when it holds this rank's
    of the sequence, `positions` staying the whole sequence's."""
    ldims = fsdp.layer_dims(dims)
    ks, vs = [], []
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    zl = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        h, new, aux = remat_call(remat, _block, cfg, lp, h, positions,
                                 None if cache is None else layer(cache, i), cache_pos, True,
                                 group, ldims, seq)
        if new is not None:
            ks.append(new["k"])
            vs.append(new["v"])
        if aux is not None:
            lb, zl = lb + aux["lb_loss"], zl + aux["z_loss"]
    new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if cache is not None else None
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps,
                         plus_one=cfg.norm_plus_one)
    return h, new_cache, {"lb_loss": lb / cfg.n_layers, "z_loss": zl / cfg.n_layers}


def _positions_for(cfg: ArchConfig, batch: dict, B: int, S: int, device) -> torch.Tensor:
    pos = batch.get("positions")
    if cfg.pos == "mrope":
        if pos is None:
            base = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
            return torch.stack([base] * 3)               # (3, B, S)
        return pos.transpose(0, 1)                       # (B, 3, S) -> (3, B, S)
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return pos


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: str = "none",
            use_kernel: bool = False, local_vocab: bool = False) -> tuple[torch.Tensor, dict]:
    """Training/eval forward. Returns (logits, aux). On shards under a
    model axis above 1, `local_vocab` gives this rank's slice of a split
    vocab's logits instead of the whole (see the module's docstring).
    `use_kernel` has no effect on this family."""
    B, S = batch["tokens"].shape
    group = tensor.group_for(cfg)
    seq = tensor.seq_range(cfg, S)
    dims = fsdp.shard_dims(cfg, params)
    emb = fsdp.gather_tree(params["embed"], fsdp.sub_dims(dims, "embed"))
    h = emb_lib.assemble_inputs(cfg, emb, batch, group, seq)
    positions = _positions_for(cfg, batch, B, S, h.device)
    h, _, aux = backbone(cfg, params, h, positions, remat=remat, group=group, dims=dims,
                         seq=seq)
    return emb_lib.lm_head(cfg, emb, h, group, gather=not local_vocab, seq=seq), aux


def prefill(cfg: ArchConfig, params: dict, batch: dict, cache: dict, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, dict]:
    """Prefill: full-sequence forward, fills `cache`, returns only the
    last-position logits (B, V). `use_kernel` has no effect on this family."""
    B, S = batch["tokens"].shape
    group = tensor.group_for(cfg)
    seq = tensor.seq_range(cfg, S)
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch, group, seq)
    positions = _positions_for(cfg, batch, B, S, h.device)
    h, new_cache, _ = backbone(cfg, params, h, positions, cache=cache, group=group, seq=seq)
    logits = emb_lib.lm_head(cfg, params["embed"], tensor.last_row(h, group, seq), group)[:, 0]
    return logits, new_cache


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, pos: torch.Tensor,
                cache: dict, extras: dict | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1); pos: (B,) current write index.
    Returns (logits (B, V), new cache). The modality inputs the caller
    leaves out are the reference's defaults: no image patch (zero
    `pixel_embeds`, a false `pixel_mask`) for vlm; zero `frame_embeds` at
    `positions` pos for audio."""
    B = tokens.shape[0]
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    if cfg.modality == "vlm":
        batch.setdefault("pixel_embeds", torch.zeros((B, 1, cfg.d_model), dtype=cfg.cdtype(),
                                                     device=tokens.device))
        batch.setdefault("pixel_mask", torch.zeros((B, 1), dtype=torch.bool,
                                                   device=tokens.device))
    if cfg.modality == "audio":
        batch.setdefault("frame_embeds", torch.zeros((B, 1, cfg.d_model), dtype=cfg.cdtype(),
                                                     device=tokens.device))
        batch.setdefault("positions", pos[:, None])
    group = tensor.group_for(cfg)
    tensor.seq_range(cfg, 1)                         # the recorded fallback
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch, group)
    positions = torch.stack([pos[:, None]] * 3) if cfg.pos == "mrope" else pos[:, None]
    h, new_cache, _ = backbone(cfg, params, h, positions, cache=cache, cache_pos=pos,
                               group=group)
    return emb_lib.lm_head(cfg, params["embed"], h, group)[:, 0], new_cache
