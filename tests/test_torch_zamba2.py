"""Zamba2's published hybrid layout in the port (`models/zamba.py`,
selected by `hybrid_layer_ids`), held to the benchmark's plain float32
reference (`gpubench/reference/zamba2.py`) on seeded random weights at a
small size on the CPU; the flash repairs it needs (lengths the blocks do
not divide, a scale of the configuration's), and the Mamba2 mixer's
gated norm taken per group.

The small model (`configs.smoke("zamba2-7b-instruct")`): 6 layers, 2 SSM
groups, 2 alternating shared blocks at 3 sites with uneven gaps (layers
1, 3, 4), adapters of rank 4, RoPE, attention on the 2·d_model input,
the published scale rule. Prompts of 2,100 tokens take the flash route
(`attention.FLASH_MIN_SEQ`) with a length its blocks (512, 1,024) do not
divide. The port runs in float32 compute there, so port and reference
agree to float32 rounding.
"""
import dataclasses
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.layers import attention, flash
from repro_torch.layers import mamba2 as m2
from repro_torch.models import api, base, zamba
from repro_torch.netgen import telemetry
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from gpubench.reference import zamba2 as ref  # noqa: E402

NAME = "zamba2-7b-instruct"
# float32 against float32, sums taken in another order (blocked flash,
# chunked scans, a fused adapter product): well under a bf16 step, 2^-8
TOL = 2e-4
PROMPT = 2100       # flash route, ragged against blocks of 512 and 1,024


def _cfg(**repl):
    return dataclasses.replace(configs.smoke(NAME), compute_dtype="float32", **repl)


def _weights(cfg, seed=0):
    return base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(seed), "cpu")


def _tokens(cfg, rows, length, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (rows, length), generator=g)


def _close(got, want, tol=TOL):
    assert (got - want).abs().max() <= tol * want.abs().max()


# -- flash: ragged lengths and a scale ---------------------------------------------------

@pytest.mark.parametrize("causal,scale", [(True, None), (True, 0.3), (False, None)])
def test_flash_at_ragged_lengths_matches_the_dense_oracle_with_gradients(causal, scale):
    """S = T = 1,021 against blocks of 256 and 512: the padded keys are
    masked and the padded queries cut, forward and both backward passes."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(1, 4, 1021, 16, generator=g).requires_grad_() for _ in range(3))
    w = torch.randn(1, 4, 1021, 16, generator=g)
    got = flash.flash_attention(q, k, v, causal=causal, q_blk=256, k_blk=512, scale=scale)
    grads = torch.autograd.grad((got * w).sum(), (q, k, v))
    want = flash.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    wgrads = torch.autograd.grad((want * w).sum(), (q, k, v))
    assert got.shape == want.shape
    _close(got, want, 2e-5)
    for a, b in zip(grads, wgrads):
        _close(a, b, 2e-5)


@pytest.mark.parametrize("kv,S,T,q_offset", [(2, 300, 300, 0), (1, 96, 300, 204)])
def test_flash_ragged_gqa_and_query_offset(kv, S, T, q_offset):
    g = torch.Generator().manual_seed(S + kv)
    q = torch.randn(2, 4, S, 8, generator=g)
    k, v = (torch.randn(2, kv, T, 8, generator=g) for _ in range(2))
    got = flash.flash_attention(q, k, v, q_blk=64, k_blk=128, q_offset=q_offset)
    _close(got, flash.flash_attention_ref(q, k, v, q_offset=q_offset), 2e-5)


def test_flash_default_scale_is_the_explicit_head_dim_rule_bit_for_bit():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 256, 16, generator=g) for _ in range(3))
    a = flash.flash_attention(q, k, v, q_blk=64, k_blk=128)
    assert torch.equal(a, flash.flash_attention(q, k, v, q_blk=64, k_blk=128, scale=0.25))
    assert not torch.equal(a, flash.flash_attention(q, k, v, q_blk=64, k_blk=128, scale=0.3))


@pytest.mark.parametrize("S,T,qb,kb,q0,want", [
    (4092, 4092, 512, 1024, 0, (32, 20)),     # the cell's longest prompt
    (2048, 2048, 512, 1024, 0, (8, 6)),
    (100, 100, 512, 1024, 0, (1, 1)),
    (96, 300, 64, 128, 204, (6, 6)),
    (300, 300, 64, 128, 0, (15, 9)),
])
def test_block_pairs_counts_what_the_loop_computes_and_the_mask_keeps(S, T, qb, kb, q0, want):
    assert flash.block_pairs(S, T, qb, kb, q_offset=q0) == want


# -- the per-group gated norm ------------------------------------------------------------

def _mixer_case(group_norm: bool):
    cfg = _cfg(ssm_group_norm=group_norm)
    p = base.layer(_weights(cfg)["layers"]["mixer"], 0)
    p = dict(p, norm_scale=1 + 0.1 * torch.randn(p["norm_scale"].shape,
                                                 generator=torch.Generator().manual_seed(2)))
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(4))
    return cfg, p, x


def test_group_norm_mixer_matches_the_reference_mixer_at_two_groups():
    """Prefill over 40 tokens and then 3 decode steps through the cache,
    against the reference's mixer (norm per group of d_inner / 2)."""
    cfg, p, x = _mixer_case(True)
    assert cfg.ssm_groups == 2
    arch = dataclasses.asdict(cfg)
    with torch.no_grad():
        want = ref._mixer(arch, p, x, ref._Ops("fp32"))
        out, state = m2.mamba_mixer(cfg, p, x[:, :37], return_state=True, use_kernel=True)
        steps = []
        for t in range(37, 40):
            y, state = m2.mamba_decode_step(cfg, p, x[:, t:t + 1], state)
            steps.append(y)
    _close(out, want[:, :37])
    _close(torch.cat(steps, dim=1), want[:, 37:])


def test_default_gated_norm_is_still_over_the_whole_d_inner():
    cfg, p, x = _mixer_case(False)
    loc = m2._local(cfg, p, None)
    y = torch.randn(2, 5, cfg.d_inner, generator=torch.Generator().manual_seed(5))
    z = torch.randn(2, 5, cfg.d_inner, generator=torch.Generator().manual_seed(6))
    g = y * torch.nn.functional.silu(z)
    whole = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * p["norm_scale"]
    got = m2._gated_norm(cfg, p, y, z, loc)
    _close(got, whole, 1e-6)
    grouped = m2._gated_norm(dataclasses.replace(cfg, ssm_group_norm=True), p, y, z, loc)
    assert (grouped - whole).abs().max() > 1e-3


# -- the model against the reference ----------------------------------------------------

def test_config_is_registered_at_the_published_widths_outside_the_reference_grid():
    cfg = configs.get_config(NAME)
    assert NAME in configs.PORT_ONLY and NAME not in configs.ARCHS
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_groups, cfg.ssm_heads, cfg.conv_dim) == \
        (81, 3584, 2, 112, 7424)
    assert zamba.published(cfg) and zamba.n_sites(cfg) == 13 and cfg.num_mem_blocks == 2
    tree = api.abstract_params(cfg)
    assert tree["blocks"]["attn"]["wq"].shape == (2, 7168, 32, 224)
    assert tree["blocks"]["attn"]["wo"].shape == (2, 32, 224, 3584)
    assert tree["sites"]["adapter_b"].shape == (13, 128, 2 * 14336)
    # mixers 6.353 B, blocks 0.668 B, sites 0.221 B, the embedding 0.115 B
    assert base.count_params(tree) == 7_356_749_648
    assert not zamba.published(configs.get_config("zamba2-2.7b"))


def test_forward_matches_the_reference():
    cfg = _cfg()
    w = _weights(cfg)
    toks = _tokens(cfg, 2, PROMPT)
    with mock.patch.object(attention, "flash_attention",
                           wraps=attention.flash_attention) as calls:
        got, aux = api.forward(cfg, w, {"tokens": toks})
    assert aux == {} and calls.call_count == zamba.n_sites(cfg)
    _close(got, ref.logits(dataclasses.asdict(cfg), w, toks, PROMPT))


def test_prefill_then_decode_matches_the_reference_at_every_position():
    """Prefill of 2,097 tokens (flash), then 3 decode steps through the 6
    SSM states and the 3 sites' KV caches, against the reference's full
    forward pass over the same 2,100 tokens."""
    cfg = _cfg()
    w = _weights(cfg, seed=3)
    B, new = 2, 4
    P = PROMPT - new + 1
    toks = _tokens(cfg, B, PROMPT, seed=5)
    want = ref.logits(dataclasses.asdict(cfg), w, toks, new)
    cache = base.tree_init(api.abstract_cache(cfg, B, PROMPT + 8),
                           torch.Generator().manual_seed(0), "cpu")
    assert cache["kv"]["k"].shape[0] == 3 and cache["ssm"]["ssm"].shape[0] == 6
    assert P >= attention.FLASH_MIN_SEQ and P % 512 and P % 1024
    with torch.inference_mode():
        lg, cache = api.prefill(cfg, w, {"tokens": toks[:, :P]}, cache, use_kernel=True)
        got = [lg]
        for i in range(new - 1):
            lg, cache = api.decode_step(cfg, w, toks[:, P + i:P + i + 1],
                                        torch.full((B,), P + i, dtype=torch.int32), cache)
            got.append(lg)
    _close(torch.stack(got, dim=1), want)


def test_sites_blocks_and_adapters_each_change_the_result():
    """A site's adapter, a site's linear and the second block each reach the
    logits, so none is dropped unnoticed."""
    cfg = _cfg()
    w = _weights(cfg)
    toks = _tokens(cfg, 1, 24)
    base_logits, _ = api.forward(cfg, w, {"tokens": toks})
    for path in (("sites", "adapter_b"), ("sites", "linear"), ("blocks", "mlp", "down")):
        w2 = base.tree_map(lambda t: t.clone(), w)
        node = w2
        for k in path[:-1]:
            node = node[k]
        node[path[-1]][-1].zero_()          # the last site's, or the second block's
        assert not torch.allclose(api.forward(cfg, w2, {"tokens": toks})[0], base_logits)


def test_the_published_layout_refuses_a_model_axis():
    cfg = _cfg()
    w = _weights(cfg)
    with mock.patch.object(zamba.tensor, "group_for", return_value=object()):
        with pytest.raises(ValueError, match="one card"):
            api.forward(cfg, w, {"tokens": _tokens(cfg, 1, 8)})
        with pytest.raises(ValueError, match="one card"):
            api.abstract_cache(cfg, 1, 8)


def test_engine_serves_it_by_name_with_block_and_attention_spans():
    """`Engine.generate` through `api.prefill` / `api.decode_step`: the
    tokens are the reference's greedy choices where the choice is clear,
    and each prefill holds one `zamba.shared_block` a site (blocks
    alternating) with its `attn.core` inside."""
    cfg = dataclasses.replace(configs.smoke(NAME), compute_dtype="float32")
    w = _weights(cfg, seed=9)
    prompts = _tokens(cfg, 2, 40, seed=2).numpy().astype(np.int32)
    telemetry.reset()
    telemetry.enable()
    try:
        out = Engine(cfg, w, ServeConfig(max_len=48, max_new_tokens=3), device="cpu").generate(
            prompts)
        spans = telemetry.get_registry().spans()
    finally:
        telemetry.disable()
        telemetry.reset()
    toks = torch.cat([torch.as_tensor(prompts).long(), torch.as_tensor(out[:, :-1]).long()], 1)
    want = ref.logits(dataclasses.asdict(cfg), w, toks, 3)
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 1e-3
    assert sure.any()
    assert torch.equal(want.argmax(-1)[sure], torch.as_tensor(out).long()[sure])
    blocks = [s for s in spans if s.name == "zamba.shared_block"]
    assert [(s.attrs["site"], s.attrs["block"]) for s in blocks[:3]] == [(0, 0), (1, 1), (2, 0)]
    assert len(blocks) == 3 * 3                         # 3 sites, a prefill and 2 steps
    ids = {s.span_id: s for s in spans}
    cores = [s for s in spans if s.name == "attn.core"]
    assert len(cores) == 9 and all(ids[s.parent_id].name == "zamba.shared_block" for s in cores)
    assert [s.attrs["route"] for s in cores[:4]] == ["dense"] * 3 + ["decode"]
    assert cores[0].attrs == {"route": "dense", "rows": 2, "q_len": 40, "kv_len": 40,
                              "heads": 4, "kv_heads": 4, "head_dim": 32, "pairs": 1,
                              "causal_pairs": 1}


# -- on the card ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_prefill_takes_b7_and_the_conv_kernel_a_layer_at_published_widths():
    """At the published widths, cut to 8 layers with sites at layers 1 and
    6 (both blocks), the benchmark's init rules: a served batch of 2 × 2,100
    tokens (flash, ragged) sends every mixer's SSD through B7's tensor
    cores and every prefill conv through the conv kernel's vector route,
    once a layer, and its served tokens are the fp32 reference's within
    the benchmark cell's gap limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    from gpubench import check, weights
    from repro_torch.kernels.causal_conv import ops as cops
    from repro_torch.kernels.ssd_scan import ops as sops
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(configs.get_config(NAME), n_layers=8, hybrid_layer_ids=(1, 6))
    init = json.loads((ROOT / "gpubench/configs/zamba2-7b-instruct.json").read_text())["init"]
    limit = json.loads((ROOT / "gpubench/limits/zamba2-7b-instruct.long_prompt.json")
                       .read_text())["gap"]
    w = weights.draw(api.abstract_params(cfg), init, 2 ** 31 + 5, dev)
    prompts = _tokens(cfg, 2, PROMPT).numpy().astype(np.int32)
    sops.reset_launches()
    cops.reset_launches()
    out = Engine(cfg, w, ServeConfig(max_len=PROMPT + 3, max_new_tokens=3),
                 device=dev).generate(prompts)
    torch.cuda.synchronize()
    assert sops.ssd.mma_launches == sops.ssd.launches == cfg.n_layers
    assert cops.causal_conv.vec_launches == cops.causal_conv.launches == cfg.n_layers
    arch = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}
    toks = torch.cat([torch.as_tensor(prompts).long(), torch.as_tensor(out[:, :-1]).long()], 1)
    gap = check.gaps(ref.logits(arch, w, toks.to(dev), 3), torch.as_tensor(out).long().to(dev))
    assert 0 <= gap.max().item() <= limit
