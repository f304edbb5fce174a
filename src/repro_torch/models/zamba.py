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

Under a model axis above 1 every entry point runs split over the model
group (`tensor.group_for`; ROADMAP.md A.7c): every mixer on its heads,
as in `models/mamba.py`; the shared block's attention and MLP on the
dense family's split (heads, kv heads and ffn that divide the axis; the
KV cache by kv heads, else by positions, `tensor.cache_len`); the
embedding and head on a vocab that divides it. The shared block's
`in_proj` ("fsdp", None) stays whole over "model"; under the
`ssm_shard` flag's "mixed" (the reference's default) the hidden state
and `emb0` hold a rank's positions of the sequence between layers
(ROADMAP.md A item 4), so it runs on S/m tokens and its gradient is
their part, which the train step sums. `forward`, which
training runs, takes the mixers' and the block's autograd collectives
and `local_vocab`, as in `models/mamba.py`. Under FSDP each mixer's
layer is gathered inside its checkpointed function, as in mamba; the
shared block, which is not remat'd, is gathered once a forward and
reused at every site, so its gathered weights are saved for the
backward once (not once a site) and its gradient, summed over the
sites by autograd, is reduce-scattered once.

Zamba2's published layout (transformers' `modeling_zamba2`), selected by
`cfg.hybrid_layer_ids`, is a second path beside the reference's, which
stays the default. With e the embedding output and h the residual
stream, layer i is h <- h + mixer_i(norm(h + t_i)), where t_i is 0
except at a site (a layer of `hybrid_layer_ids`): there, t_i is the
output of shared block b = s mod `num_mem_blocks` at site s, through
the site's own linear L_s. The block has no residual of its own:
x = rms_2d(cat(h, e)); a = attention(x) (q, k, v from the 2·d_model-wide
x, `wo` back to d_model, RoPE, the published scale (head_dim / 2)^-1/2);
t = L_s(mlp(rms(a))), the MLP's gate|up product plus the site's
low-rank adapter A_s B_s (rank `adapter_rank`), with the exact GELU
(`layers/mlp.py` `adapted_mlp`). The mixers take `cfg.ssm_group_norm`,
Zamba2's gated norm per group. Its parameters: `blocks` (stacked over
the blocks) and `sites` (each site's adapter and linear, stacked over
the sites) beside `layers`; its decode state: the SSM cache stacked over
the layers and the KV cache over the sites. It runs on one card: under a
model axis above 1 every entry point raises `ValueError`.

Spans (`netgen.telemetry`, live only while traced), in the published
layout's `prefill` and `decode_step`: `model.embed`, one `model.layer`
a layer (norm, mixer, residual, the state's copies into the new cache's
stacks), one `zamba.shared_block` a site (`site`, `block`; the
attention's `attn.core` inside it), `model.cache_stack` (the site's K/V
into its stack) and `model.head`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.layers import attention as attn_lib
from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import mamba2 as m2
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import norms
from repro_torch.layers.common import wx
from repro_torch.models.base import ArchConfig, ParamInfo, layer, remat_call, tree_map, unstack
from repro_torch.models.mamba import layer_body
from repro_torch.netgen.telemetry import span
from repro_torch.parallel import fsdp, tensor

__all__ = ["published", "n_sites", "abstract_params", "abstract_cache", "forward", "prefill",
           "decode_step"]


def published(cfg: ArchConfig) -> bool:
    """Whether `cfg` selects Zamba2's published layout (see the module's
    docstring) over the reference's."""
    return bool(cfg.hybrid_layer_ids)


def n_sites(cfg: ArchConfig) -> int:
    if published(cfg):
        return len(cfg.hybrid_layer_ids)
    return cfg.n_layers // cfg.attn_every


def abstract_params(cfg: ArchConfig) -> dict:
    L = cfg.n_layers
    if published(cfg):
        return _published_params(cfg)
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
        return lambda i: dataclasses.replace(i, shape=(n,) + i.shape,
                                             logical=(None,) + i.logical, init="zeros")

    if published(cfg):
        _one_card(cfg)
    return {"ssm": tree_map(stack(cfg.n_layers), m2.ssm_cache_info(cfg, batch)),
            "kv": tree_map(stack(n_sites(cfg)), attn_lib.init_cache_info(cfg, batch, max_len))}


def _groups(cfg: ArchConfig):
    """Layer indices of each group of `attn_every` mixers, one group a site."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.attn_every}")
    k = cfg.attn_every
    return [range(g * k, (g + 1) * k) for g in range(n_sites(cfg))]


def _shared_block(cfg: ArchConfig, sp: dict, h, emb0, positions, cache_kv, cache_pos,
                  group=None, seq=None):
    """The shared attention+MLP block. Returns (h, new_kv_cache). `group`:
    the model group when sp holds shards; `seq`: the positions of h and
    emb0 when they hold this rank's of the sequence."""
    x = torch.matmul(torch.cat([h, emb0], dim=-1), wx(sp["in_proj"], h.dtype))
    xn = norms.apply_norm(cfg.norm, sp["ln_attn"], x, eps=cfg.norm_eps)
    a, new_kv = attn_lib.attention(cfg, sp["attn"], xn, positions, cache=cache_kv,
                                   cache_pos=cache_pos, group=group, seq=seq)
    x = x + a
    xn = norms.apply_norm(cfg.norm, sp["ln_mlp"], x, eps=cfg.norm_eps)
    x = x + mlp_lib.mlp(cfg, sp["mlp"], xn, group, seq)
    return h + x, new_kv


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: str = "none",
            use_kernel: bool = False, local_vocab: bool = False) -> tuple[torch.Tensor, dict]:
    """Training/eval forward: (logits, {}); `local_vocab` as in
    `models/mamba.py`."""
    if published(cfg):
        return _published_forward(cfg, params, batch, remat, use_kernel)
    B, S = batch["tokens"].shape
    mg = tensor.group_for(cfg)
    seq = tensor.seq_range(cfg, S)
    dims = fsdp.shard_dims(cfg, params)
    emb = fsdp.gather_tree(params["embed"], fsdp.sub_dims(dims, "embed"))
    shared = fsdp.gather_tree(params["shared"], fsdp.sub_dims(dims, "shared"))
    ldims = fsdp.layer_dims(dims)
    h = emb_lib.assemble_inputs(cfg, emb, batch, mg, seq)
    emb0, positions = h, _positions(B, S, h.device)
    layers = unstack(params["layers"], cfg.n_layers)
    for group in _groups(cfg):
        for i in group:
            h = remat_call(remat, layer_body, cfg, layers[i], h, use_kernel, mg, ldims, seq)
        h, _ = _shared_block(cfg, shared, h, emb0, positions, None, None, mg, seq)
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    return emb_lib.lm_head(cfg, emb, h, mg, gather=not local_vocab, seq=seq), {}


def prefill(cfg: ArchConfig, params: dict, batch: dict, cache: dict, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, dict]:
    """Run the prompt, filling each site's KV cache and building every
    layer's SSM state (cast to the cache's dtypes). Returns the last
    position's logits (B, V) and the new cache."""
    if published(cfg):
        return _published_serve(cfg, params, batch, cache, use_kernel=use_kernel)
    B, S = batch["tokens"].shape
    mg = tensor.group_for(cfg)
    seq = tensor.seq_range(cfg, S)
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch, mg, seq)
    emb0, positions = h, _positions(B, S, h.device)
    convs, ssms, ks, vs = [], [], [], []
    layers = unstack(params["layers"], cfg.n_layers)
    for g, group in enumerate(_groups(cfg)):
        for i in group:
            lp = layers[i]
            hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
            out, state = m2.mamba_mixer(cfg, lp["mixer"], hn, return_state=True,
                                        use_kernel=use_kernel, group=mg, seq=seq)
            h = h + out
            convs.append(state["conv"].to(cache["ssm"]["conv"].dtype))
            ssms.append(state["ssm"].to(cache["ssm"]["ssm"].dtype))
        h, kv = _shared_block(cfg, params["shared"], h, emb0, positions,
                              layer(cache["kv"], g), None, mg, seq)
        ks.append(kv["k"])
        vs.append(kv["v"])
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    logits = emb_lib.lm_head(cfg, params["embed"], tensor.last_row(h, mg, seq), mg)[:, 0]
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
    if published(cfg):
        return _published_serve(cfg, params, batch, cache, pos)
    mg = tensor.group_for(cfg)
    tensor.seq_range(cfg, 1)                         # the recorded fallback
    h = emb_lib.assemble_inputs(cfg, params["embed"], batch, mg)
    emb0, positions = h, pos[:, None]
    convs, ssms, ks, vs = [], [], [], []
    layers = unstack(params["layers"], cfg.n_layers)
    for g, group in enumerate(_groups(cfg)):
        for i in group:
            lp = layers[i]
            hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
            out, new = m2.mamba_decode_step(cfg, lp["mixer"], hn, layer(cache["ssm"], i), mg)
            h = h + out
            convs.append(new["conv"])
            ssms.append(new["ssm"])
        h, kv = _shared_block(cfg, params["shared"], h, emb0, positions,
                              layer(cache["kv"], g), pos, mg)
        ks.append(kv["k"])
        vs.append(kv["v"])
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    logits = emb_lib.lm_head(cfg, params["embed"], h, mg)[:, 0]
    return logits, {"ssm": {"conv": torch.stack(convs), "ssm": torch.stack(ssms)},
                    "kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}


# -- Zamba2's published layout --------------------------------------------------------


def _published_params(cfg: ArchConfig) -> dict:
    L, nb, ns = cfg.n_layers, cfg.num_mem_blocks, n_sites(cfg)
    d, r = cfg.d_model, cfg.adapter_rank

    def per_site(*shape):
        return ParamInfo((ns, *shape), torch.float32, (None,) * (1 + len(shape)), fan=1)

    return {
        "embed": emb_lib.embed_params(cfg),
        "layers": {
            "ln": norms.norm_params(cfg.norm, d, L),
            "mixer": m2.mamba_params(cfg, L),
        },
        "blocks": {
            "ln_in": norms.norm_params(cfg.norm, 2 * d, nb),
            "attn": attn_lib.attn_params(cfg, nb, d_in=2 * d),
            "ln_mlp": norms.norm_params(cfg.norm, d, nb),
            "mlp": mlp_lib.adapted_mlp_params(cfg, nb),
        },
        "sites": {"adapter_a": per_site(d, r), "adapter_b": per_site(r, 2 * cfg.d_ff),
                  "linear": per_site(d, d)},
        "final_norm": norms.norm_params(cfg.norm, d),
    }


def _one_card(cfg: ArchConfig) -> None:
    if tensor.group_for(cfg) is not None:
        raise ValueError(f"{cfg.name}: Zamba2's published hybrid layout runs on one card; "
                         "it is not split over a model axis above 1")


def _site_of(cfg: ArchConfig) -> dict:
    """{layer index: site index} of the sites."""
    ids = cfg.hybrid_layer_ids
    if sorted(set(ids)) != list(ids) or not 0 <= ids[0] <= ids[-1] < cfg.n_layers:
        raise ValueError(f"hybrid_layer_ids {ids}: want increasing layers of "
                         f"{cfg.n_layers}")
    return {i: s for s, i in enumerate(ids)}


def _site_block(cfg: ArchConfig, blocks: list, sites: list, s: int, h, emb0, positions,
                cache_kv=None, cache_pos=None):
    """Site s: shared block s mod num_mem_blocks on (h, emb0), through the
    site's adapter and linear. Returns (t_s (B, S, d), the site's K/V)."""
    b = s % cfg.num_mem_blocks
    bp, sp = blocks[b], sites[s]
    with span("zamba.shared_block", site=s, block=b):
        x = norms.apply_norm(cfg.norm, bp["ln_in"], torch.cat([h, emb0], dim=-1),
                             eps=cfg.norm_eps)
        a, kv = attn_lib.attention(cfg, bp["attn"], x, positions, cache=cache_kv,
                                   cache_pos=cache_pos, scale=(cfg.head_dim / 2) ** -0.5)
        m = mlp_lib.adapted_mlp(bp["mlp"], norms.apply_norm(cfg.norm, bp["ln_mlp"], a,
                                                           eps=cfg.norm_eps),
                                sp["adapter_a"], sp["adapter_b"])
        return torch.matmul(m, wx(sp["linear"], m.dtype)), kv


def _published_forward(cfg: ArchConfig, params: dict, batch: dict, remat: str,
                       use_kernel: bool) -> tuple[torch.Tensor, dict]:
    _one_card(cfg)
    B, S = batch["tokens"].shape
    dims = fsdp.shard_dims(cfg, params)
    emb = fsdp.gather_tree(params["embed"], fsdp.sub_dims(dims, "embed"))
    blocks = unstack(fsdp.gather_tree(params["blocks"], fsdp.sub_dims(dims, "blocks")),
                     cfg.num_mem_blocks)
    sites = unstack(fsdp.gather_tree(params["sites"], fsdp.sub_dims(dims, "sites")),
                    n_sites(cfg))
    ldims = fsdp.layer_dims(dims)
    site_of = _site_of(cfg)
    h = emb_lib.assemble_inputs(cfg, emb, batch)
    emb0, positions = h, _positions(B, S, h.device)
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        t = None
        if i in site_of:
            t, _ = _site_block(cfg, blocks, sites, site_of[i], h, emb0, positions)
        h = remat_call(remat, layer_body, cfg, lp, h, use_kernel, None, ldims, None, t)
    h = norms.apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    return emb_lib.lm_head(cfg, emb, h), {}


def _mixer_input(cfg: ArchConfig, lp: dict, h, t):
    return norms.apply_norm(cfg.norm, lp["ln"], h if t is None else h + t, eps=cfg.norm_eps)


def _published_serve(cfg: ArchConfig, params: dict, batch: dict, cache: dict,
                     pos: torch.Tensor | None = None, use_kernel: bool = False
                     ) -> tuple[torch.Tensor, dict]:
    """`prefill` (pos None) or one `decode_step` (pos (B,), the write
    index): the last position's logits (B, V) and the new cache. Each
    layer's SSM state and each site's K/V are copied into stacks allocated
    once, each as it is made."""
    _one_card(cfg)
    B, S = batch["tokens"].shape
    site_of = _site_of(cfg)
    blocks = unstack(params["blocks"], cfg.num_mem_blocks)
    sites = unstack(params["sites"], n_sites(cfg))
    new = tree_map(torch.empty_like, cache)
    with span("model.embed"):
        h = emb_lib.assemble_inputs(cfg, params["embed"], batch)
    emb0 = h
    positions = _positions(B, S, h.device) if pos is None else pos[:, None]
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        t = None
        if i in site_of:
            s = site_of[i]
            t, kv = _site_block(cfg, blocks, sites, s, h, emb0, positions,
                                layer(cache["kv"], s), pos)
            with span("model.cache_stack"):
                new["kv"]["k"][s].copy_(kv["k"])
                new["kv"]["v"][s].copy_(kv["v"])
        with span("model.layer"):
            x = _mixer_input(cfg, lp, h, t)
            if pos is None:
                out, state = m2.mamba_mixer(cfg, lp["mixer"], x, return_state=True,
                                            use_kernel=use_kernel)
            else:
                out, state = m2.mamba_decode_step(cfg, lp["mixer"], x, layer(cache["ssm"], i))
            h = h + out
            new["ssm"]["conv"][i].copy_(state["conv"])
            new["ssm"]["ssm"][i].copy_(state["ssm"])
    with span("model.head"):
        h = norms.apply_norm(cfg.norm, params["final_norm"], h[:, -1:], eps=cfg.norm_eps)
        logits = emb_lib.lm_head(cfg, params["embed"], h)[:, 0]
    return logits, new
