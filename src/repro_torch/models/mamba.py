"""Mamba2 LM: embedding -> L x (norm -> SSD mixer) -> norm -> head.

Counterpart of `repro/models/mamba.py`. Parameters of the layers are
stacked on a leading (n_layers,) axis, as in the reference; its
`lax.scan` over them is a Python loop over the layers' slices
(`base.unstack`); the cache's slices are `base.layer`'s. `remat="full"`
recomputes each layer of `forward` in the backward pass
(`base.remat_call`). Attention-free: the decode state is O(1) in
sequence length.

Under a model axis above 1 every entry point runs split over the model
group (`tensor.group_for`; ROADMAP.md A.7c): every mixer on its heads
(`layers/mamba2.py`), the embedding and head on a vocab that divides the
axis; `prefill` and `decode_step` with the cache's slice
(`tensor.local_tree`), and `forward`, which training runs, with the
mixer's autograd collectives; its `local_vocab=True` keeps the head's
logits split over the vocab for `api.loss_fn`. A train state cut over
"data" too (FSDP, `parallel/fsdp.py`: `in_proj`'s and `out_proj`'s d
rows, the embedding's and head's d) is gathered a layer at a time
inside the function that `remat_call` checkpoints, so the recompute
gathers again, as `models/transformer.py` does; the embedding's leaves
where `forward` uses them. Under the `ssm_shard` flag's "mixed" (the
reference's default) `forward` and `prefill` split the hidden state
along the sequence between layers, as `models/transformer.py` does
(ROADMAP.md A item 4); "heads" keeps it whole.

`prefill` and `decode_step` open the spans (`netgen.telemetry`, live only
while traced) `model.embed`, one `model.layer` a layer (norm, mixer,
residual, the state's casts), `model.head` and `model.cache_stack`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import mamba2 as m2
from repro_torch.layers import norms
from repro_torch.models.base import ArchConfig, layer, remat_call, tree_map, unstack
from repro_torch.netgen.telemetry import span
from repro_torch.parallel import fsdp, tensor

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
    return tree_map(lambda i: dataclasses.replace(i, shape=(cfg.n_layers,) + i.shape,
                                                  logical=(None,) + i.logical), info)


def layer_body(cfg: ArchConfig, lp: dict, h: torch.Tensor, use_kernel: bool, group=None,
               dims=None, seq=None, t=None) -> torch.Tensor:
    """One Mamba2 layer (norm, mixer, residual) on layer slice `lp`; the
    hybrid family's mixers run it too. `group`: the model group when lp
    holds shards; `dims`: the fsdp dims of lp's shards, gathered here
    (`fsdp.gather_tree`); `seq`: h's positions when it holds this rank's
    of the sequence; `t`: added to the mixer's input, not to the residual
    (a Zamba2 site's shared-block output)."""
    lp = fsdp.gather_tree(lp, dims)
    hn = norms.apply_norm(cfg.norm, lp["ln"], h if t is None else h + t, eps=cfg.norm_eps)
    return h + m2.mamba_mixer(cfg, lp["mixer"], hn, use_kernel=use_kernel, group=group,
                              seq=seq)


def backbone(cfg: ArchConfig, params: dict, h: torch.Tensor, *, remat: str = "none",
             use_kernel: bool = False, group=None, dims: dict | None = None,
             seq=None) -> torch.Tensor:
    """Every layer, then the final norm. `group`, `dims` (`fsdp.shard_dims`
    of `params`) and `seq` as `layer_body`'s."""
    ldims = fsdp.layer_dims(dims)
    for lp in unstack(params["layers"], cfg.n_layers):
        h = remat_call(remat, layer_body, cfg, lp, h, use_kernel, group, ldims, seq)
    return norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: str = "none",
            use_kernel: bool = False, local_vocab: bool = False) -> tuple[torch.Tensor, dict]:
    """Training/eval forward: (logits, {}). On shards under a model axis
    above 1, `local_vocab` gives this rank's slice of a split vocab's
    logits instead of the whole (see the module's docstring)."""
    group = tensor.group_for(cfg)
    seq = tensor.seq_range(cfg, batch["tokens"].shape[1])
    dims = fsdp.shard_dims(cfg, params)
    emb = fsdp.gather_tree(params["embed"], fsdp.sub_dims(dims, "embed"))
    h = emb_lib.assemble_inputs(cfg, emb, batch, group, seq)
    h = backbone(cfg, params, h, remat=remat, use_kernel=use_kernel, group=group, dims=dims,
                 seq=seq)
    return emb_lib.lm_head(cfg, emb, h, group, gather=not local_vocab, seq=seq), {}


def prefill(cfg: ArchConfig, params: dict, batch: dict, cache: dict, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, dict]:
    """Run the chunked scan over the prompt and build the decode state.
    Returns the last position's logits (B, V) and a cache advanced
    through the whole prompt (a new tree; `cache` gives the dtypes)."""
    group = tensor.group_for(cfg)
    seq = tensor.seq_range(cfg, batch["tokens"].shape[1])
    with span("model.embed"):
        h = emb_lib.assemble_inputs(cfg, params["embed"], batch, group, seq)
    convs, ssms = [], []
    for lp in unstack(params["layers"], cfg.n_layers):
        with span("model.layer"):
            hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
            out, state = m2.mamba_mixer(cfg, lp["mixer"], hn, return_state=True,
                                        use_kernel=use_kernel, group=group, seq=seq)
            h = h + out
            convs.append(state["conv"].to(cache["conv"].dtype))
            ssms.append(state["ssm"].to(cache["ssm"].dtype))
    with span("model.head"):
        h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
        logits = emb_lib.lm_head(cfg, params["embed"], tensor.last_row(h, group, seq),
                                 group)[:, 0]
    with span("model.cache_stack"):
        return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cache: dict,
                extras: dict | None = None) -> tuple[torch.Tensor, dict]:
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    group = tensor.group_for(cfg)
    tensor.seq_range(cfg, 1)                         # the recorded fallback
    with span("model.embed"):
        h = emb_lib.assemble_inputs(cfg, params["embed"], batch, group)
    convs, ssms = [], []
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        with span("model.layer"):
            hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
            out, new = m2.mamba_decode_step(cfg, lp["mixer"], hn, layer(cache, i), group)
            h = h + out
            convs.append(new["conv"])
            ssms.append(new["ssm"])
    with span("model.head"):
        h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
        logits = emb_lib.lm_head(cfg, params["embed"], h, group)[:, 0]
    with span("model.cache_stack"):
        return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
