"""Parity of the port's dense-transformer layers with the JAX package's, on
the CPU: rotary positions, the norms, the gated MLPs, attention with its
KV cache (the reference's default `grouped`/`where` variants), flash
attention and its backward, and the embedding cases (tied, scaled in
bf16, W8 heads).

Inputs are made from seeds with numpy; weights are made by the JAX package
and carried into the port with `models.convert.from_jax_params`.
Tolerances: 1e-4 absolute and relative on fp32 paths (summation order of
the same fp32 algorithm); flash as `tests/test_flash.py` holds it (2e-5
in fp32, 5e-2 in bf16, gradients 3e-4); the embedding in bf16 exactly.
The JAX side of an fp32 comparison runs under `jax.jit` (`_jit`), which
compiles once instead of op by op; bf16 comparisons run it eagerly, so
every op rounds to bf16 as the reference's own tests see it.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.layers import attention as jattn
from repro.layers import embedding as jemb
from repro.layers import flash as jflash
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rotary as jrotary
from repro.models import base as jbase
from repro.quantized import apply as japply
from repro_torch import configs
from repro_torch.layers import attention, embedding, flash, mlp, norms, rotary
from repro_torch.models import base, convert
from repro_torch.quantized import apply

TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _cfgs(arch, **repl):
    """(JAX, port) smoke configs in fp32 compute, with `repl` applied."""
    repl = {"compute_dtype": "float32", **repl}
    return (dataclasses.replace(jconfigs.smoke(arch), **repl),
            dataclasses.replace(configs.smoke(arch), **repl))


def _carry(tree):
    """A JAX tree -> (the JAX tree, the port's tree of CPU tensors)."""
    return tree, convert.from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jit(fn, *args):
    """fn(*args) under a fresh `jax.jit`."""
    return jax.jit(fn)(*args)


# -- rotary -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1.0e4, 5.0e6])
def test_rope_matches_jax(theta, dtype):
    x = _normal(0, 2, 37, 3, 16)
    pos = np.random.default_rng(1).integers(0, 4096, size=(2, 37)).astype(np.int32)
    got = rotary.rope(_t(x).to(getattr(torch, dtype)), _t(pos), theta)
    want = jrotary.rope(jnp.asarray(x, dtype), jnp.asarray(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    # angles up to 4096 rad: an ulp of a frequency moves them by ~2e-4
    _close(got.float().numpy(), want, tol=2e-3 if dtype == "float32" else 2e-2)


def test_mrope_and_sinusoidal_match_jax():
    x = _normal(2, 2, 9, 4, 16)
    pos = np.random.default_rng(3).integers(0, 64, size=(3, 2, 9)).astype(np.int32)
    _close(rotary.mrope(_t(x), _t(pos), 1e6, (2, 3, 3)).numpy(),
           _jit(lambda a, b: jrotary.mrope(a, b, 1e6, (2, 3, 3)), x, pos))
    with pytest.raises(ValueError):
        rotary.mrope(_t(x), _t(pos), 1e6, (2, 2, 2))
    p2 = pos[0]
    _close(rotary.sinusoidal_embedding(_t(p2), 64).numpy(),
           _jit(lambda a: jrotary.sinusoidal_embedding(a, 64), p2))


# -- norms --------------------------------------------------------------------

@pytest.mark.parametrize("kind,plus_one", [("rmsnorm", False), ("rmsnorm", True),
                                           ("layernorm", False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(kind, plus_one, dtype):
    info = jnorms.norm_params(kind, 64, plus_one=plus_one)
    ported = norms.norm_params(kind, 64, plus_one=plus_one)
    assert sorted(info) == sorted(ported)
    for k in info:
        assert ported[k].shape == info[k].shape and ported[k].init == info[k].init
    p = {k: _normal(10 + i, 64, scale=0.3) + (0.0 if plus_one else 1.0)
         for i, k in enumerate(sorted(info))}
    x = _normal(4, 2, 5, 64, scale=3.0) + 0.5
    got = norms.apply_norm(kind, {k: _t(v) for k, v in p.items()},
                           _t(x).to(getattr(torch, dtype)), eps=1e-6, plus_one=plus_one)
    want = jnorms.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x, dtype), eps=1e-6, plus_one=plus_one)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want, tol=TOL if dtype == "float32" else 2e-2)


# -- gated MLPs ---------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("w8", [False, True])
def test_mlp_matches_jax(act, w8):
    jcfg, cfg = _cfgs("gemma-2b", act=act)
    pj = jbase.tree_init(jmlp.mlp_params(jcfg), jax.random.PRNGKey(3))
    if w8:
        pj = japply.quantize_params_for_serving(jcfg, pj, min_size=0)
    pj, pt = _carry(pj)
    assert sorted(pt) == sorted(mlp.mlp_params(cfg))
    x = _normal(5, 2, 7, 64)
    _close(mlp.mlp(cfg, pt, _t(x)).numpy(), _jit(lambda p, a: jmlp.mlp(jcfg, p, a), pj, x))


# -- attention ----------------------------------------------------------------

# MHA (qwen1.5), GQA (llama, kv 2 of the smoke's 4 heads), MQA (gemma)
ATTN_ARCHS = {"mha": ("qwen1.5-4b", {}), "gqa": ("llama3.2-3b", {"n_kv_heads": 2}),
              "mqa": ("gemma-2b", {})}


@pytest.fixture(scope="module", params=sorted(ATTN_ARCHS))
def attn_layer(request):
    arch, repl = ATTN_ARCHS[request.param]
    jcfg, cfg = _cfgs(arch, **repl)
    pj = jbase.tree_init(jattn.attn_params(jcfg), jax.random.PRNGKey(4))
    if jcfg.qkv_bias:       # biases initialize to zero: make them matter
        pj = {**pj, **{k: jnp.asarray(_normal(20 + i, *pj[k].shape, scale=0.5))
                       for i, k in enumerate(("bq", "bk", "bv"))}}
    return (request.param, jcfg, cfg, *_carry(pj))


def _run_both(jcfg, cfg, pj, pt, x, positions, cache, cache_pos, causal=True):
    tcache = None if cache is None else {k: _t(v) for k, v in cache.items()}
    got, got_cache = attention.attention(
        cfg, pt, _t(x), _t(positions), cache=tcache,
        cache_pos=None if cache_pos is None else _t(cache_pos), causal=causal)
    want, want_cache = _jit(
        lambda p, a, pos, c, cp: jattn.attention(jcfg, p, a, pos, cache=c, cache_pos=cp,
                                                 causal=causal),
        pj, x, positions, cache, cache_pos)
    return got, got_cache, want, want_cache, tcache


@pytest.mark.parametrize("S", [1, 13])
@pytest.mark.parametrize("mode", ["prefill", "prefill_cache"])
def test_attention_prefill_matches_jax(attn_layer, mode, S):
    """A prompt of 13 tokens (causal mask) and of one (no mask)."""
    _, jcfg, cfg, pj, pt = attn_layer
    B, S_max = 2, 24
    x = _normal(6, B, S, 64)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    cache = None
    if mode == "prefill_cache":     # prefill ignores what the cache held
        shape = (B, cfg.n_kv_heads, S_max, cfg.head_dim)
        cache = {"k": _normal(7, *shape), "v": _normal(8, *shape)}
    got, got_cache, want, want_cache, _ = _run_both(jcfg, cfg, pj, pt, x, positions,
                                                    cache, None)
    assert got.shape == (B, S, 64)
    _close(got.numpy(), want)
    if cache is None:
        assert got_cache is None and want_cache is None
    else:
        for k in ("k", "v"):
            assert got_cache[k].shape == cache[k].shape
            _close(got_cache[k].numpy(), want_cache[k])
            assert torch.all(got_cache[k][:, :, S:] == 0)


@pytest.mark.parametrize("cache_pos", [[5, 11, 23], [0, 0, 0], [7, 7, 7], [23, 23, 23]],
                         ids=["mixed", "first", "equal", "last"])
def test_attention_decode_matches_jax(attn_layer, cache_pos):
    """One decode step at per-sequence write indices (mixed, all at the
    first row, all equal mid-cache, all at the last row): the new row lands
    at cache_pos and only positions <= cache_pos are read. The input cache
    is left as it was."""
    _, jcfg, cfg, pj, pt = attn_layer
    B, S_max = 3, 24
    shape = (B, cfg.n_kv_heads, S_max, cfg.head_dim)
    cache = {"k": _normal(9, *shape), "v": _normal(10, *shape)}
    cache_pos = np.array(cache_pos, np.int32)
    x = _normal(11, B, 1, 64)
    got, got_cache, want, want_cache, tcache = _run_both(
        jcfg, cfg, pj, pt, x, cache_pos[:, None], cache, cache_pos)
    _close(got.numpy(), want)
    for k in ("k", "v"):
        _close(got_cache[k].numpy(), want_cache[k])
        np.testing.assert_array_equal(tcache[k].numpy(), cache[k])
        changed = (got_cache[k] != tcache[k]).any(dim=(1, 3))        # (B, S_max)
        assert changed.nonzero()[:, 1].tolist() == cache_pos.tolist()
    with pytest.raises(ValueError, match="S == 1"):
        attention.attention(cfg, pt, _t(_normal(12, B, 2, 64)), _t(np.zeros((B, 2), np.int32)),
                            cache=tcache, cache_pos=_t(cache_pos))


def test_attention_long_prompt_takes_the_flash_route():
    """S = FLASH_MIN_SEQ (2048), kept narrow (batch 1, 2 heads, kv 1, head
    dim 16): both packages take their flash route and agree."""
    S = attention.FLASH_MIN_SEQ
    jcfg, cfg = _cfgs("llama3.2-3b", d_model=32, n_heads=2, n_kv_heads=1)
    pj, pt = _carry(jbase.tree_init(jattn.attn_params(jcfg), jax.random.PRNGKey(5)))
    x = _normal(13, 1, S, 32)
    positions = np.arange(S, dtype=np.int32)[None]
    with mock.patch.object(attention, "flash_attention",
                           wraps=attention.flash_attention) as calls:
        got, _ = attention.attention(cfg, pt, _t(x), _t(positions))
    assert calls.call_count == 1
    want, _ = _jit(lambda p, a, pos: jattn.attention(jcfg, p, a, pos), pj, x, positions)
    _close(got.numpy(), want)


def test_attention_params_and_cache_layout(attn_layer):
    _, jcfg, cfg, _, _ = attn_layer
    for n_layers in (None, 3):
        ported, ref = attention.attn_params(cfg, n_layers), jattn.attn_params(jcfg, n_layers)
        assert sorted(ported) == sorted(ref)
        for k in ref:
            assert (ported[k].shape, ported[k].init, ported[k].fan) == \
                (ref[k].shape, ref[k].init, ref[k].fan), k
    info = attention.init_cache_info(cfg, 3, 40)
    assert info["k"].shape == (3, cfg.n_kv_heads, 40, cfg.head_dim)
    assert info["v"].dtype == torch.float32 and info["k"].init == "zeros"


@pytest.mark.parametrize("case", ["mrope", "sin", "non_causal"])
def test_attention_positions_and_mask_match_jax(case):
    """The other position schemes (M-RoPE over (3, B, S) positions; `sin`,
    which rotates nothing here) and a prefill without the causal mask, on
    llama's GQA smoke layer."""
    repl = {"n_kv_heads": 2}
    if case != "non_causal":
        repl.update(pos=case, mrope_sections=(2, 3, 3) if case == "mrope" else ())
    jcfg, cfg = _cfgs("llama3.2-3b", **repl)
    pj, pt = _carry(jbase.tree_init(jattn.attn_params(jcfg), jax.random.PRNGKey(7)))
    B, S = 2, 11
    positions = np.random.default_rng(14).integers(0, 64, size=(B, S)).astype(np.int32)
    if case == "mrope":
        positions = np.random.default_rng(15).integers(0, 64, size=(3, B, S)).astype(np.int32)
    got, _, want, _, _ = _run_both(jcfg, cfg, pj, pt, _normal(16, B, S, 64), positions,
                                   None, None, causal=case != "non_causal")
    _close(got.numpy(), want)


# -- flash attention ----------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,s,hd,qb,kb", [
    (2, 4, 4, 256, 32, 64, 64),
    (1, 8, 2, 512, 64, 128, 128),    # GQA rep=4
    (2, 4, 1, 256, 32, 64, 128),     # MQA, uneven blocks
    (1, 4, 4, 384, 16, 128, 128),
])
def test_flash_matches_jax_and_dense(b, h, kv, s, hd, qb, kb):
    rng = np.random.default_rng(s + hd)
    q, k, v = (rng.normal(size=(b, n, s, hd)).astype(np.float32) for n in (h, kv, kv))
    got = flash.flash_attention(_t(q), _t(k), _t(v), causal=True, q_blk=qb, k_blk=kb)
    want = _jit(lambda *a: jflash.flash_attention(*a, causal=True, q_blk=qb, k_blk=kb),
                q, k, v)
    _close(got.numpy(), want, tol=2e-5)
    dense = flash.flash_attention_ref(_t(q), _t(k), _t(v))
    _close(dense.numpy(), _jit(jflash.flash_attention_ref, q, k, v), tol=2e-5)
    _close(got.numpy(), dense.numpy(), tol=2e-5)


def test_flash_bf16_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, n, 256, 32)) for n in (4, 2, 2))
    got = flash.flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                                q_blk=64, k_blk=64)
    want = jflash.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                  q_blk=64, k_blk=64)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, tol=5e-2)


def test_flash_non_causal_and_block_check():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, 2, 128, 16)).astype(np.float32) for _ in range(3))
    got = flash.flash_attention(_t(q), _t(k), _t(v), causal=False, q_blk=32, k_blk=64)
    want = _jit(lambda *a: jflash.flash_attention(*a, causal=False, q_blk=32, k_blk=64),
                q, k, v)
    _close(got.numpy(), want, tol=2e-5)
    # blocks that do not divide the length pad it (ROADMAP F3): the dense oracle
    ragged = flash.flash_attention(_t(q), _t(k), _t(v), causal=False, q_blk=48, k_blk=80)
    dense = flash.flash_attention_ref(_t(q), _t(k), _t(v), causal=False)
    _close(ragged.numpy(), dense.numpy(), tol=2e-5)
    with pytest.raises(ValueError, match="blocks of at least 1"):
        flash.flash_attention(_t(q), _t(k), _t(v), q_blk=0)


@pytest.mark.parametrize("kv,qb,kb", [(4, 64, 64), (2, 64, 128), (1, 128, 64)])
def test_flash_backward_matches_jax_custom_vjp(kv, qb, kb):
    """The autograd.Function's two-pass recomputation backward against the
    reference's custom_vjp, on a weighted sum so every position counts."""
    rng = np.random.default_rng(kv * 100 + qb)
    q = rng.normal(size=(2, 4, 256, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, kv, 256, 32)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(2, 4, 256, 32)).astype(np.float32)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (flash.flash_attention(tq, tk, tv, q_blk=qb, k_blk=kb) * _t(w)).sum().backward()
    jg = _jit(jax.grad(lambda *a: (jflash.flash_attention(*a, q_blk=qb, k_blk=kb) * w).sum(),
                       argnums=(0, 1, 2)), q, k, v)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got.numpy(), want, tol=3e-4)


# -- embedding and LM head ----------------------------------------------------

def _embed_cfgs(arch, **repl):
    jcfg, cfg = _cfgs(arch, **repl)
    pj, pt = _carry(jbase.tree_init(jemb.embed_params(jcfg), jax.random.PRNGKey(6)))
    return jcfg, cfg, pj, pt


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "llama3.2-3b"], ids=["untied", "tied"])
@pytest.mark.parametrize("w8", [False, True])
def test_embedding_and_head_match_jax(arch, w8):
    """The separate head and the tied one (`tokᵀ`, no `head` leaf), from
    fp32 leaves and from W8 ones (the tied W8 head folds the per-d_model
    scales into h)."""
    jcfg, cfg, pj, pt = _embed_cfgs(arch)
    assert ("head" in pt) == (not cfg.tie_embeddings)
    if w8:
        pj = japply.quantize_params_for_serving(jcfg, {"embed": pj}, min_size=0)["embed"]
        pt = apply.quantize_params_for_serving(cfg, {"embed": pt}, min_size=0)["embed"]
        assert pt["tok"]["s"].shape == (cfg.d_model,)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    h = embedding.embed(cfg, pt, _t(toks).long())
    _close(h.numpy(), _jit(lambda p, t: jemb.embed(jcfg, p, t), pj, toks))
    x = _normal(8, 2, 9, 64)
    _close(embedding.lm_head(cfg, pt, _t(x)).numpy(),
           _jit(lambda p, a: jemb.lm_head(jcfg, p, a), pj, x))


def test_scaled_embedding_rounds_its_scale_in_bf16():
    """gemma multiplies by sqrt(d_model) rounded to h's dtype first: at
    d_model 2048 that is 45.25 in bf16, not 45.2548..., and the port's
    bf16 embedding equals the reference's bit for bit."""
    jcfg, cfg, pj, pt = _embed_cfgs("gemma-2b", d_model=2048, vocab=32,
                                    compute_dtype="bfloat16")
    toks = np.arange(32, dtype=np.int32).reshape(2, 16)
    got = embedding.embed(cfg, pt, _t(toks).long())
    want = np.asarray(jemb.embed(jcfg, pj, jnp.asarray(toks)).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = (pt["tok"][_t(toks).long()].to(torch.bfloat16) * 2048 ** 0.5).float()
    assert not torch.equal(got.float(), unrounded)


def test_unported_modalities_raise():
    """The vlm and audio inputs of a dense config switched to each modality
    equal the reference's (patches where the mask is set; frames plus
    sinusoidal positions where `pos` is "sin"); a modality neither
    package has raises ValueError in both."""
    for modality, pos in (("vlm", "mrope"), ("audio", "sin"), ("audio", "rope")):
        jcfg, cfg = _cfgs("qwen1.5-4b", modality=modality, pos=pos,
                          mrope_sections=(2, 3, 3) if pos == "mrope" else ())
        pj, pt = _carry(jbase.tree_init(jemb.embed_params(jcfg), jax.random.PRNGKey(6)))
        rng = np.random.default_rng(9)
        batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 7)).astype(np.int32),
                 "pixel_embeds": rng.normal(size=(2, 7, 64)).astype(np.float32),
                 "pixel_mask": rng.random((2, 7)) < 0.5,
                 "frame_embeds": (rng.normal(size=(2, 7, 64)) * 0.02).astype(np.float32)}
        got = embedding.assemble_inputs(cfg, pt, {k: _t(v) for k, v in batch.items()})
        _close(got.numpy(), _jit(lambda p, b: jemb.assemble_inputs(jcfg, p, b), pj, batch))
    for c in (cfg, jcfg):
        with pytest.raises(ValueError):
            (embedding if c is cfg else jemb).assemble_inputs(
                dataclasses.replace(c, modality="video"), pt if c is cfg else pj,
                {"tokens": _t(batch["tokens"]) if c is cfg else batch["tokens"]})
