"""Parity of the port's dense transformer family with the JAX package's, on
the CPU, at the `configs.smoke(...)` size of each dense config
(qwen1.5-4b, gemma-2b, llama3.2-3b, qwen2-72b: 2 layers, d_model 64,
4 heads of 16, vocab 512): forward and loss, prefill and decode steps,
the serving engine from fp32 and W8 weights, the configs, the launcher,
the example, and the port's copy of the data pipeline.

Weights are made once per config by the JAX package and carried into the
port with `models.convert.from_jax_params`. Tolerance: 1e-4 absolute and
relative on fp32 paths (summation order of the same fp32 algorithm); the
bf16 serving case states its bound at its test. The JAX side of an fp32
comparison runs under `jax.jit`, which compiles once instead of op by op.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.models import base as jbase
from repro.quantized import apply as japply
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import api, base, convert
from repro_torch.quantized import apply
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
DENSE = ("qwen1.5-4b", "gemma-2b", "llama3.2-3b", "qwen2-72b")
PARAMS = {"qwen1.5-4b": 3_950_369_280, "gemma-2b": 2_506_172_416,
          "llama3.2-3b": 3_212_749_824, "qwen2-72b": 72_706_203_648}


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.smoke(arch), compute_dtype=dtype),
            dataclasses.replace(configs.smoke(arch), compute_dtype=dtype))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _prompts(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(0))
    if jcfg.qkv_bias:       # biases initialize to zero: make them matter
        attn = dict(pj["layers"]["attn"])
        for i, k in enumerate(("bq", "bk", "bv")):
            attn[k] = jnp.asarray(np.random.default_rng(i).normal(
                size=attn[k].shape).astype(np.float32) * 0.5)
        pj = {**pj, "layers": {**pj["layers"], "attn": attn}}
    return jcfg, cfg, pj, convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")


def test_forward_and_loss_match_jax(model):
    jcfg, cfg, pj, pt = model
    toks = _prompts(4, 2, 33)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    logits, aux = api.forward(cfg, pt, {"tokens": torch.from_numpy(batch["tokens"]).long()})
    logits_j, aux_j = jax.jit(lambda p, t: japi.forward(jcfg, p, {"tokens": t}))(
        pj, batch["tokens"])
    assert logits.shape == (2, 32, 512)
    _close(logits.numpy(), logits_j)
    assert sorted(aux) == sorted(aux_j) and all(float(v) == 0 for v in aux.values())
    loss, _ = api.loss_fn(cfg, pt, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                          use_kernel=True)
    loss_j, _ = jax.jit(lambda p, b: japi.loss_fn(jcfg, p, b))(pj, batch)
    assert abs(float(loss) - float(loss_j)) < TOL


def test_prefill_and_decode_steps_match_jax(model):
    """Prefill fills the (L, B, KV, S, hd) cache; two decode steps write at
    per-sequence positions that differ."""
    jcfg, cfg, pj, pt = model
    toks = _prompts(3, 2, 20)
    cache = base.tree_init(api.abstract_cache(cfg, 2, 32), torch.Generator(), "cpu")
    assert cache["k"].shape == (2, 2, cfg.n_kv_heads, 32, cfg.head_dim)
    logits, cache = api.prefill(cfg, pt, {"tokens": torch.from_numpy(toks).long()}, cache)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 2, 32), jax.random.PRNGKey(0))
    logits_j, jcache = jax.jit(lambda p, t, c: japi.prefill(jcfg, p, {"tokens": t}, c))(
        pj, toks, jcache)
    assert logits.shape == (2, 512)
    _close(logits.numpy(), logits_j)
    for k in ("k", "v"):
        _close(cache[k].numpy(), jcache[k])
    pos = np.array([20, 17], np.int32)
    jstep = jax.jit(lambda p, t, ps, c: japi.decode_step(jcfg, p, t, ps, c))
    for step in range(2):
        nxt = _prompts(10 + step, 2, 1)
        logits, cache = api.decode_step(cfg, pt, torch.from_numpy(nxt).long(),
                                        torch.from_numpy(pos + step), cache)
        logits_j, jcache = jstep(pj, nxt, pos + step, jcache)
        _close(logits.numpy(), logits_j)
        for k in ("k", "v"):
            _close(cache[k].numpy(), jcache[k])


@pytest.mark.parametrize("w8", [False, True])
def test_engine_generates_jax_tokens(model, w8):
    jcfg, cfg, pj, pt = model
    if w8:
        pj = japply.quantize_params_for_serving(jcfg, pj, min_size=0)
        pt = apply.quantize_params_for_serving(cfg, pt, min_size=0)
    prompts = _prompts(5, 3, 12)
    out = Engine(cfg, pt, ServeConfig(max_len=24, max_new_tokens=5),
                 device="cpu").generate(prompts)
    want = JEngine(jcfg, pj, JServeConfig(max_len=24, max_new_tokens=5)).generate(prompts)
    assert out.shape == (3, 5) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)


def test_engine_bf16_close_to_jax():
    """Compute dtype bf16, as configured (qwen1.5's smoke). Both round
    activations to bf16 after every matmul, but XLA and torch sum and round
    bf16 products at other places, so last-position logits agree to 0.1
    absolute: logits here reach |4|, where a bf16 ulp is 0.0156, and two
    ulps have been seen; 0.1 leaves a margin of three. Greedy tokens must
    agree wherever JAX's top-2 margin exceeds twice that."""
    jcfg, cfg = _cfgs("qwen1.5-4b", "bfloat16")
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(1))
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    toks = _prompts(6, 4, 24)
    cache = base.tree_init(api.abstract_cache(cfg, 4, 32), torch.Generator(), "cpu")
    logits, _ = api.prefill(cfg, pt, {"tokens": torch.from_numpy(toks).long()}, cache)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 4, 32), jax.random.PRNGKey(0))
    logits_j, _ = japi.prefill(jcfg, pj, {"tokens": jnp.asarray(toks)}, jcache)
    assert logits.dtype == torch.bfloat16
    lj = np.asarray(logits_j, np.float32)
    np.testing.assert_allclose(logits.float().numpy(), lj, atol=0.1, rtol=0)
    top2 = np.sort(lj, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 0.2
    out = Engine(cfg, pt, ServeConfig(max_len=32, max_new_tokens=1),
                 device="cpu").generate(toks)
    np.testing.assert_array_equal(out[sure, 0], lj.argmax(-1)[sure])


# the port's fields of Zamba2's published hybrid layout, which the reference lacks
_PORT_ONLY = ("hybrid_layer_ids", "num_mem_blocks", "adapter_rank", "ssm_group_norm")


def _reference_fields(cfg) -> dict:
    """The port's config as the reference's fields: all but
    `norm_plus_one`, which the reference decides from the config's name,
    and the port-only fields of Zamba2's layout (`_PORT_ONLY`)."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "norm_plus_one" and k not in _PORT_ONLY}


@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert _reference_fields(cfg) == dataclasses.asdict(jcfg)
    assert cfg.norm_plus_one == jcfg.name.startswith("gemma")   # the reference's switch
    assert cfg.family == "dense" and cfg.cdtype() == torch.bfloat16
    n = base.count_params(api.abstract_params(cfg))
    assert n == jbase.count_params(japi.abstract_params(jcfg)) == PARAMS[arch]
    small, jsmall = configs.smoke(arch), jconfigs.smoke(arch)
    assert _reference_fields(small) == dataclasses.asdict(jsmall)
    assert small.norm_plus_one == jsmall.name.startswith("gemma")


def test_renamed_gemma_keeps_its_norm_scale():
    """gemma's (1 + w) norm scale is a field of the config, not its name:
    a renamed copy declares the same tree (scales initialized to 0) and
    gives the same logits; switching the field off changes them."""
    cfg = dataclasses.replace(configs.smoke("gemma-2b"), compute_dtype="float32")
    renamed = dataclasses.replace(cfg, name="my-model")
    tree = api.abstract_params(renamed)
    assert tree["final_norm"]["scale"].init == tree["layers"]["ln_mlp"]["scale"].init == "zeros"
    params = base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": torch.from_numpy(_prompts(17, 2, 9)).long()}
    logits = api.forward(cfg, params, toks)[0]
    assert torch.equal(api.forward(renamed, params, toks)[0], logits)
    plain = dataclasses.replace(renamed, norm_plus_one=False)
    assert api.abstract_params(plain)["final_norm"]["scale"].init == "ones"
    assert not torch.allclose(api.forward(plain, params, toks)[0], logits)


def test_abstract_trees_equal_the_reference(model):
    jcfg, cfg, _, _ = model
    pairs = ((api.abstract_params(cfg), japi.abstract_params(jcfg)),
             (api.abstract_cache(cfg, 3, 40), japi.abstract_cache(jcfg, 3, 40)))
    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], f"{path}['{k}']")
        else:
            yield path, (tree.shape, tree.init, tree.fan)

    for ported, ref in pairs:
        ref_flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=jbase.is_info)[0]
        assert list(walk(ported)) == [(jax.tree_util.keystr(p), (i.shape, i.init, i.fan))
                                      for p, i in ref_flat]
    if cfg.norm_plus_one:                   # gemma's (1 + w) norm scale starts at 0
        assert api.abstract_params(cfg)["final_norm"]["scale"].init == "zeros"


def test_from_jax_params_carries_a_dense_w8_tree(model):
    jcfg, cfg, pj, _ = model
    qj = japply.quantize_params_for_serving(jcfg, pj, min_size=0)
    qt = convert.from_jax_params(jax.tree.map(np.asarray, qj), device="cpu")
    wq = qt["layers"]["attn"]["wq"]
    assert sorted(wq) == ["q", "s"] and wq["q"].dtype == torch.int8
    assert wq["s"].shape == (cfg.n_layers, cfg.head_dim) and wq["s"].dtype == torch.float32
    np.testing.assert_array_equal(wq["q"].numpy(), np.asarray(qj["layers"]["attn"]["wq"]["q"]))
    ported = apply.quantize_params_for_serving(
        cfg, convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu"), min_size=0)
    assert torch.equal(ported["embed"]["tok"]["q"], qt["embed"]["tok"]["q"])


@pytest.mark.parametrize("modality,arch", [("vlm", "qwen2-vl-2b"), ("audio", "musicgen-medium")])
def test_unported_families_raise(modality, arch):
    """The vlm and audio kinds of transformer: their configs equal the
    reference's, and a dense and a MoE config switched to their modality
    run `forward` on the pipeline's extras equal to the reference; one
    switched to a modality neither package has raises ValueError."""
    assert _reference_fields(configs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    for name in ("qwen1.5-4b", "granite-moe-1b-a400m"):
        jcfg, cfg = (dataclasses.replace(c, modality=modality) for c in _cfgs(name))
        pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(3))
        pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
        b = jpipeline.make_batch(jcfg, jbase.ShapeConfig("t", 12, 2, "train"), 0, seed=1)
        b = {k: v for k, v in b.items() if k != "positions"}    # rope, not M-RoPE
        logits, _ = api.forward(cfg, pt, {k: torch.from_numpy(v) for k, v in b.items()})
        _close(logits.numpy(), jax.jit(lambda p, x: japi.forward(jcfg, p, x))(pj, b)[0])
        with pytest.raises(ValueError):
            api.forward(dataclasses.replace(cfg, modality="video"), pt,
                        {"tokens": torch.zeros((1, 4), dtype=torch.long)})


@pytest.mark.parametrize("w8", [False, True])
def test_launcher_serves_qwen_smoke(capsys, w8):
    """`python -m repro_torch.launch.serve --arch qwen1.5-4b --smoke
    --device cpu [--w8]`: the reference's summary line."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--new-tokens", "3", *(["--w8"] if w8 else [])])
    assert out.shape == (2, 3) and (out >= 0).all() and (out < 512).all()
    text = capsys.readouterr().out
    assert "generated 6 tokens in" in text
    assert ("W8-specialized" in text) == w8


def test_torch_serve_lm_example():
    """examples/torch_serve_lm.py on the CPU: generation, then the W8
    checkpoint's storage and loss and the prune statistics."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_lm.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    for text in ("== batched generation ==", "new_tokens=16", "storage:", "int8-weights=",
                 "structurally dead channels"):
        assert text in proc.stdout, text


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-2b", "musicgen-medium"],
                         ids=["text", "vlm", "audio"])
def test_make_batch_equals_the_reference(arch):
    """The port's copy of the data pipeline gives the reference's batches,
    for every modality."""
    jcfg = jconfigs.smoke(arch)
    cfg = base.ArchConfig(**dataclasses.asdict(jcfg))
    shape = jbase.ShapeConfig("smoke", 24, 3, "train")
    for step in (0, 5):
        got = pipeline.make_batch(cfg, base.ShapeConfig(**dataclasses.asdict(shape)), step,
                                  seed=7)
        want = jpipeline.make_batch(jcfg, shape, step, seed=7)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
