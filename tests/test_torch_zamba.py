"""Parity of the port's hybrid family (zamba2) with the JAX package's, on
the CPU, at `configs.smoke("zamba2-2.7b")` (4 Mamba2 layers, the shared
attention+MLP block after every 2, d_model 64, 4 heads of 16, N = 16,
vocab 512): forward, prefill and decode steps with the plain SSD and with
`use_kernel=True` (which on the CPU takes the kernel's plain version,
`kernels/ssd_scan/ref.py`; the reference's zamba has no kernel route, so
both are held to its one route), the W8 forward, the serving engine, the
config, the abstract trees and the launcher.

Weights are made by the JAX package and carried into the port with
`models.convert.from_jax_params`. Tolerance: 1e-4 absolute and relative
on fp32 paths (summation order of the same fp32 algorithm). The JAX side
runs under `jax.jit`, which compiles once instead of op by op.
"""
import dataclasses
import math
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import base as jbase
from repro.quantized import apply as japply
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import api, base, convert, zamba
from repro_torch.quantized import apply
from repro_torch.serve.engine import Engine, ServeConfig

TOL = 1e-4
ARCH = "zamba2-2.7b"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _prompts(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _close_trees(got, want):
    """Every leaf of the port's tree against the JAX tree's, same paths."""
    pairs = list(_leaves(got))
    assert [p for p, _ in pairs] == [tuple(k.key for k in path) for path, _ in
                                     jax.tree_util.tree_flatten_with_path(want)[0]]
    for path, leaf in pairs:
        ref = want
        for k in path:
            ref = ref[k]
        assert tuple(leaf.shape) == ref.shape, path
        _close(leaf.float().numpy(), ref)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), compute_dtype="float32")
    cfg = dataclasses.replace(configs.smoke(ARCH), compute_dtype="float32")
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, pj, convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(model, use_kernel):
    jcfg, cfg, pj, pt = model
    toks = _prompts(1, 2, 24)
    with mock.patch.object(ssd_ops, "ssd", wraps=ssd_ops.ssd) as ssd:
        logits, aux = api.forward(cfg, pt, {"tokens": torch.from_numpy(toks).long()},
                                  use_kernel=use_kernel)
    assert ssd.call_count == (cfg.n_layers if use_kernel else 0)
    logits_j, aux_j = jax.jit(lambda p, t: japi.forward(jcfg, p, {"tokens": t}))(pj, toks)
    assert logits.shape == (2, 24, 512) and aux == aux_j == {}
    _close(logits.numpy(), logits_j)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_steps_match_jax(model, use_kernel):
    """Prefill fills the KV cache of each of the 2 sites and the SSM
    cache of each of the 4 layers; two decode steps follow, at
    per-sequence positions that differ."""
    jcfg, cfg, pj, pt = model
    toks = _prompts(3, 2, 20)
    cache = base.tree_init(api.abstract_cache(cfg, 2, 32), torch.Generator(), "cpu")
    with mock.patch.object(ssd_ops, "ssd", wraps=ssd_ops.ssd) as ssd:
        logits, cache = api.prefill(cfg, pt, {"tokens": torch.from_numpy(toks).long()}, cache,
                                    use_kernel=use_kernel)
    assert ssd.call_count == (cfg.n_layers if use_kernel else 0)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 2, 32), jax.random.PRNGKey(0))
    logits_j, jcache = jax.jit(lambda p, t, c: japi.prefill(jcfg, p, {"tokens": t}, c))(
        pj, toks, jcache)
    assert logits.shape == (2, 512)
    _close(logits.numpy(), logits_j)
    _close_trees(cache, jcache)
    pos = np.array([20, 17], np.int32)
    jstep = jax.jit(lambda p, t, ps, c: japi.decode_step(jcfg, p, t, ps, c))
    for step in range(2):
        nxt = _prompts(10 + step, 2, 1)
        logits, cache = api.decode_step(cfg, pt, torch.from_numpy(nxt).long(),
                                        torch.from_numpy(pos + step), cache)
        logits_j, jcache = jstep(pj, nxt, pos + step, jcache)
        _close(logits.numpy(), logits_j)
        _close_trees(cache, jcache)


def test_w8_forward_matches_jax(model):
    """The W8 checkpoint at the quantization's default size floor (the
    stacked mixer weights are int8; the shared block's weights, under
    16,384 values each at this size, stay fp32) against JAX's W8
    forward: the same int8 values and scales, dequantized by both in fp32."""
    jcfg, cfg, pj, pt = model
    qj = japply.quantize_params_for_serving(jcfg, pj)
    qt = apply.quantize_params_for_serving(cfg, pt)
    assert all(isinstance(t, torch.Tensor) for _, t in _leaves(qt["shared"]))
    for k in ("in_proj", "out_proj"):
        assert sorted(qt["layers"]["mixer"][k]) == ["q", "s"]
        np.testing.assert_array_equal(qt["layers"]["mixer"][k]["q"].numpy(),
                                      np.asarray(qj["layers"]["mixer"][k]["q"]))
    toks = _prompts(2, 2, 16)
    logits, _ = api.forward(cfg, qt, {"tokens": torch.from_numpy(toks).long()}, use_kernel=True)
    logits_j, _ = jax.jit(lambda p, t: japi.forward(jcfg, p, {"tokens": t}))(qj, toks)
    _close(logits.numpy(), logits_j)


def test_w8_shared_attention_weights_are_served(model):
    """With every matmul weight quantized (min_size=0, as the launcher and
    the card serve it), the shared block's un-stacked (d, H, hd) and
    (H, hd, d) attention weights carry per-(first, last) scales. The
    reference's `wx` cannot broadcast them and raises; the port's
    dequantizes q * s over the middle dim. Held to JAX's forward on the
    same W8 tree with those four leaves dequantized in numpy."""
    jcfg, cfg, pj, pt = model
    qj = japply.quantize_params_for_serving(jcfg, pj, min_size=0)
    qt = apply.quantize_params_for_serving(cfg, pt, min_size=0)
    toks = _prompts(2, 2, 16)
    with pytest.raises(ValueError, match="broadcast"):
        japi.forward(jcfg, qj, {"tokens": toks})
    attn = {}
    for k, leaf in qj["shared"]["attn"].items():
        q, s = np.asarray(leaf["q"], np.float32), np.asarray(leaf["s"])
        assert s.shape == (q.shape[0], q.shape[-1])
        attn[k] = q * s[:, None, :]
        np.testing.assert_array_equal(qt["shared"]["attn"][k]["q"].numpy(), leaf["q"])
    qj = {**qj, "shared": {**qj["shared"], "attn": attn}}
    logits, _ = api.forward(cfg, qt, {"tokens": torch.from_numpy(toks).long()})
    logits_j, _ = jax.jit(lambda p, t: japi.forward(jcfg, p, {"tokens": t}))(qj, toks)
    _close(logits.numpy(), logits_j)


@pytest.mark.parametrize("w8", [False, True])
def test_engine_generates_jax_tokens(model, w8):
    jcfg, cfg, pj, pt = model
    if w8:
        pj = japply.quantize_params_for_serving(jcfg, pj)
        pt = apply.quantize_params_for_serving(cfg, pt)
    prompts = _prompts(5, 3, 12)
    with mock.patch.object(ssd_ops, "ssd", wraps=ssd_ops.ssd) as ssd:
        out = Engine(cfg, pt, ServeConfig(max_len=24, max_new_tokens=5),
                     device="cpu").generate(prompts)
    assert ssd.call_count == cfg.n_layers       # the engine's prefill takes the kernel route
    want = JEngine(jcfg, pj, JServeConfig(max_len=24, max_new_tokens=5)).generate(prompts)
    assert out.shape == (3, 5) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)


def test_loss_fn_matches_jax(model):
    """A hybrid's forward returns no aux, so its metrics are nll and loss."""
    jcfg, cfg, pj, pt = model
    toks = _prompts(6, 2, 17)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss, metrics = api.loss_fn(cfg, pt, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    _, metrics_j = jax.jit(lambda p, b: japi.loss_fn(jcfg, p, b))(pj, batch)
    assert sorted(metrics) == sorted(metrics_j) == ["loss", "nll"]
    for k in metrics:
        assert abs(float(metrics[k]) - float(metrics_j[k])) < TOL, k


def test_config_and_abstract_trees_equal_the_reference():
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    for f in dataclasses.fields(jcfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.norm_plus_one is False and cfg.family == "hybrid"
    assert api.module_for(cfg) is zamba and zamba.n_sites(cfg) == 9
    assert base.count_params(api.abstract_params(cfg)) == \
        jbase.count_params(japi.abstract_params(jcfg)) == 2_409_563_040
    small, jsmall = configs.smoke(ARCH), jconfigs.smoke(ARCH)
    assert {f.name: getattr(small, f.name) for f in dataclasses.fields(jsmall)} == \
        dataclasses.asdict(jsmall)
    assert (small.n_layers, small.attn_every, small.ssm_state) == (4, 2, 16)
    for ported, ref in ((api.abstract_params(small), japi.abstract_params(jsmall)),
                        (api.abstract_cache(small, 3, 40), japi.abstract_cache(jsmall, 3, 40))):
        ref_flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=jbase.is_info)[0]
        assert [(p, (i.shape, i.init, i.fan)) for p, i in _leaves(ported)] == \
            [(tuple(k.key for k in p), (i.shape, i.init, i.fan)) for p, i in ref_flat]


def test_full_width_cache_is_stacked_over_sites_and_layers():
    """At 4 x 544 the KV cache is (9 sites, 4, 32, 544, 80) bf16 for k and
    for v; the SSM cache stacks all 54 layers in fp32."""
    cfg = configs.get_config(ARCH)
    cache = api.abstract_cache(cfg, 4, 544)
    for k in ("k", "v"):
        assert cache["kv"][k].shape == (9, 4, 32, 544, 80)
        assert cache["kv"][k].dtype == torch.bfloat16
    assert cache["ssm"]["ssm"].shape == (54, 4, 80, 64, 64)
    assert cache["ssm"]["conv"].shape == (54, 4, 3, 5120 + 2 * 64)
    assert cache["ssm"]["ssm"].dtype == cache["ssm"]["conv"].dtype == torch.float32
    nbytes = sum(math.prod(i.shape) * i.dtype.itemsize for _, i in _leaves(cache))
    assert nbytes == 2 * 9 * 4 * 32 * 544 * 80 * 2 + 54 * 4 * (80 * 64 * 64 + 3 * 5248) * 4


def test_groups_must_divide_the_layers(model):
    _, cfg, _, pt = model
    with pytest.raises(ValueError, match="attn_every"):
        api.forward(dataclasses.replace(cfg, attn_every=3), pt,
                    {"tokens": torch.zeros((1, 4), dtype=torch.long)})


@pytest.mark.parametrize("w8", [False, True])
def test_launcher_serves_zamba_smoke(capsys, w8):
    """`python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke
    --device cpu [--w8]`: the reference's summary line."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--new-tokens", "3", *(["--w8"] if w8 else [])])
    assert out.shape == (2, 3) and (out >= 0).all() and (out < 512).all()
    text = capsys.readouterr().out
    assert "generated 6 tokens in" in text and ("W8-specialized" in text) == w8
