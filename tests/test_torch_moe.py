"""Parity of the port's MoE family with the JAX package's, on the CPU, at
the `configs.smoke(...)` size of granite-moe-1b-a400m and
qwen3-moe-30b-a3b (2 layers, d_model 64, 8 experts of d_ff 96, top 2,
vocab 512): the `moe` layer (output, aux losses, expert choices and the
routed pairs it keeps or drops), the MoE transformer's forward, prefill
and decode steps, the serving engine, `loss_fn`'s metrics (dense and
MoE), the configs, and `abstract_quantized_params` for every registered
config.

Weights are made by the JAX package (or by numpy from a seed) and carried
into the port. Tolerance: 1e-4 absolute and relative on fp32 paths
(summation order of the same fp32 algorithm); expert ids, kept pairs and
greedy tokens must be equal. The JAX side of a model comparison runs
under `jax.jit`, which compiles once instead of op by op.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.layers import moe as jmoe
from repro.models import api as japi
from repro.models import base as jbase
from repro.quantized import apply as japply
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.layers import moe
from repro_torch.models import api, base, convert, transformer
from repro_torch.quantized import apply
from repro_torch.serve.engine import Engine, ServeConfig

TOL = 1e-4
MOE = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
PARAMS = {"granite-moe-1b-a400m": 1_334_628_352, "qwen3-moe-30b-a3b": 30_532_110_336}


def _cfgs(arch, **repl):
    repl = {"compute_dtype": "float32", **repl}
    return (dataclasses.replace(jconfigs.smoke(arch), **repl),
            dataclasses.replace(configs.smoke(arch), **repl))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _prompts(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _leaves(tree, path=""):
    if isinstance(tree, dict) and set(tree) != {"q", "s"}:
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}['{k}']")
    else:
        yield path, tree


def _jax_routing(jcfg, router, x, capacity_factor):
    """The reference's router and dispatch (`repro/layers/moe.py:60-97`),
    line for line: expert ids (T, K), and the tokens and keep mask of the
    routed pairs in expert-sorted order."""
    E, K = jcfg.n_experts, jcfg.experts_per_token
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router.astype(jnp.float32), axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, K)
    capacity = min(int(max(1, capacity_factor * T * K / E)), T)
    flat_expert = expert_ids.reshape(-1)
    flat_token = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)
    order = jnp.argsort(flat_expert, stable=True)
    se, stok = flat_expert[order], flat_token[order]
    pos = jnp.cumsum(jnp.ones_like(se)) - 1
    pos = pos - jnp.searchsorted(se, jnp.arange(E, dtype=se.dtype), side="left")[se]
    return np.asarray(expert_ids), np.asarray(stok), np.asarray(pos < capacity), capacity


# (b, s, capacity_factor, router) per case; "decode" is a 4-token step
# (capacity 1), "dropping" a capacity under the mean load, "tie" a zero
# router (every probability equal, so every choice is a tie)
LAYER_CASES = {"prefill": (2, 16, 1.25, "normal"), "dropping": (2, 16, 0.5, "normal"),
               "decode": (4, 1, 1.25, "normal"), "tie": (2, 16, 1.25, "zeros")}


@pytest.mark.parametrize("experts", [(8, 2), (32, 8)], ids=["e8k2", "e32k8"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
@pytest.mark.parametrize("norm_topk", [True, False])
def test_moe_layer_matches_jax(case, experts, norm_topk):
    """Output and aux losses within 1e-4; expert ids, the routed pairs'
    tokens and which of them are kept equal to the reference's. (32, 8)
    is granite's routing (32 experts, top 8) at a narrow width."""
    b, s, cf, router = LAYER_CASES[case]
    E, K = experts
    jcfg, cfg = _cfgs("granite-moe-1b-a400m", n_experts=E, experts_per_token=K,
                      moe_norm_topk=norm_topk)
    rng = np.random.default_rng(E + 3 * s + int(10 * cf))
    d, f = cfg.d_model, cfg.d_ff
    p = {"router": np.zeros((d, E), np.float32) if router == "zeros"
         else rng.normal(size=(d, E)).astype(np.float32) * d ** -0.5,
         "wi": rng.normal(size=(E, d, f)).astype(np.float32) * d ** -0.5,
         "wg": rng.normal(size=(E, d, f)).astype(np.float32) * d ** -0.5,
         "wo": rng.normal(size=(E, f, d)).astype(np.float32) * f ** -0.5}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    out, aux = moe.moe(cfg, pt, torch.from_numpy(x), capacity_factor=cf)
    out_j, aux_j = jmoe.moe(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                            capacity_factor=cf)
    _close(out.numpy(), out_j)
    for k in ("lb_loss", "z_loss"):
        _close(aux[k].numpy(), aux_j[k])

    ids_j, stok_j, keep_j, cap = _jax_routing(jcfg, jnp.asarray(p["router"]), x, cf)
    xt = torch.from_numpy(x).reshape(-1, d)
    _, _, gates, ids = moe.route(cfg, pt["router"], xt)
    assert moe.capacity(b * s, K, E, cf) == cap
    stok, _, slot, keep = moe.dispatch(ids, gates, E, cap)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(stok.numpy(), stok_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    assert bool((slot[~keep] == E * cap).all()) and len(set(slot[keep].tolist())) == int(keep.sum())
    if case == "tie":
        assert (ids == torch.arange(K)).all()          # ties go to the lower expert index
    if case in ("dropping", "decode", "tie"):
        assert not keep.all()                          # some routed pairs are dropped
    if case == "decode":
        assert cap == 1


def test_capacity_is_the_reference_arithmetic():
    """granite at 4 x 512: 640 pairs an expert; a 4-token decode step: 1."""
    assert moe.capacity(4 * 512, 8, 32) == 640
    assert moe.capacity(4, 8, 32) == 1
    assert moe.capacity(3, 2, 8, capacity_factor=100.0) == 3     # never above T


@pytest.fixture(scope="module", params=MOE)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, pj, convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")


def test_forward_matches_jax(model):
    jcfg, cfg, pj, pt = model
    toks = _prompts(4, 2, 32)
    logits, aux = api.forward(cfg, pt, {"tokens": torch.from_numpy(toks).long()})
    logits_j, aux_j = jax.jit(lambda p, t: japi.forward(jcfg, p, {"tokens": t}))(pj, toks)
    assert logits.shape == (2, 32, 512) and sorted(aux) == sorted(aux_j)
    _close(logits.numpy(), logits_j)
    for k in aux:
        _close(aux[k].numpy(), aux_j[k])
    assert float(aux["lb_loss"]) > 0 and float(aux["z_loss"]) > 0


def test_prefill_and_decode_steps_match_jax(model):
    """Prefill at T = 2 x 20 (capacity 10), then two decode steps at
    T = 2 (capacity 1, so pairs are dropped), at per-sequence positions
    that differ."""
    jcfg, cfg, pj, pt = model
    toks = _prompts(3, 2, 20)
    cache = base.tree_init(api.abstract_cache(cfg, 2, 32), torch.Generator(), "cpu")
    logits, cache = api.prefill(cfg, pt, {"tokens": torch.from_numpy(toks).long()}, cache)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 2, 32), jax.random.PRNGKey(0))
    logits_j, jcache = jax.jit(lambda p, t, c: japi.prefill(jcfg, p, {"tokens": t}, c))(
        pj, toks, jcache)
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


def test_engine_generates_jax_tokens(model):
    jcfg, cfg, pj, pt = model
    prompts = _prompts(5, 3, 12)
    out = Engine(cfg, pt, ServeConfig(max_len=24, max_new_tokens=5),
                 device="cpu").generate(prompts)
    want = JEngine(jcfg, pj, JServeConfig(max_len=24, max_new_tokens=5)).generate(prompts)
    assert out.shape == (3, 5) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)


def test_w8_experts_raise_as_the_reference_fails(model):
    """The reference reads expert weights with `.astype`, so its W8 MoE
    raises (AttributeError, `repro/layers/moe.py:116`); the port raises a
    TypeError that names that line instead of serving what the reference
    cannot."""
    jcfg, cfg, pj, pt = model
    qj = japply.quantize_params_for_serving(jcfg, pj)
    qt = apply.quantize_params_for_serving(cfg, pt)
    assert sorted(qt["layers"]["moe"]["wi"]) == ["q", "s"]
    toks = _prompts(6, 1, 4)
    with pytest.raises(AttributeError, match="astype"):
        japi.forward(jcfg, qj, {"tokens": jnp.asarray(toks)})
    with pytest.raises(TypeError, match="repro/layers/moe.py:116"):
        api.forward(cfg, qt, {"tokens": torch.from_numpy(toks).long()})


@pytest.mark.parametrize("arch", ("qwen1.5-4b",) + MOE)
def test_loss_fn_metrics_match_jax(arch):
    """loss_fn's metrics, keys and values, on a make_batch batch: nll,
    loss, and the aux losses (zeros for dense), with loss = nll +
    0.01 lb_loss + 1e-3 z_loss, as the reference's."""
    jcfg, cfg = _cfgs(arch)
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(1))
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    shape = jbase.ShapeConfig("t", 24, 2, "train")
    batch = pipeline.make_batch(cfg, base.ShapeConfig("t", 24, 2, "train"), 0, seed=3)
    jbatch = jpipeline.make_batch(jcfg, shape, 0, seed=3)
    assert all(np.array_equal(batch[k], jbatch[k]) for k in jbatch)
    loss, metrics = api.loss_fn(cfg, pt, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    _, metrics_j = jax.jit(lambda p, b: japi.loss_fn(jcfg, p, b))(pj, jbatch)
    assert sorted(metrics) == sorted(metrics_j) == ["lb_loss", "loss", "nll", "z_loss"]
    for k in metrics:
        assert abs(float(metrics[k]) - float(metrics_j[k])) < TOL, k
    assert (api.LB_WEIGHT, api.Z_WEIGHT) == (japi.LB_WEIGHT, japi.Z_WEIGHT)
    want = metrics["nll"] + api.LB_WEIGHT * metrics["lb_loss"] + api.Z_WEIGHT * metrics["z_loss"]
    assert float(loss) == float(metrics["loss"]) == pytest.approx(float(want), rel=1e-6)
    if cfg.family == "dense":
        assert float(metrics["lb_loss"]) == float(metrics["z_loss"]) == 0.0


@pytest.mark.parametrize("arch", MOE)
def test_configs_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for f in dataclasses.fields(jcfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.norm_plus_one is False and cfg.family == "moe"
    assert api.module_for(cfg) is transformer
    n = base.count_params(api.abstract_params(cfg))
    assert n == jbase.count_params(japi.abstract_params(jcfg)) == PARAMS[arch]
    small, jsmall = configs.smoke(arch), jconfigs.smoke(arch)
    assert {f.name: getattr(small, f.name) for f in dataclasses.fields(jsmall)} == \
        dataclasses.asdict(jsmall)
    assert (small.n_experts, small.experts_per_token) == (8, 2)
    tree, jtree = api.abstract_params(small), japi.abstract_params(jsmall)
    ref_flat = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=jbase.is_info)[0]
    assert [(p, (i.shape, i.init, i.fan)) for p, i in _leaves(tree)] == \
        [(jax.tree_util.keystr(p), (i.shape, i.init, i.fan)) for p, i in ref_flat]


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_abstract_quantized_params_equal_the_reference(arch):
    """Leaf for leaf: paths, shapes, dtypes and inits equal to the
    reference's, scales per (stack, out-channel); nothing is allocated
    (qwen3-moe-30b-a3b's tree declares 30.6 GB)."""
    got = list(_leaves(apply.abstract_quantized_params(configs.get_config(arch))))
    want = jax.tree_util.tree_flatten_with_path(
        japply.abstract_quantized_params(jconfigs.get_config(arch)), is_leaf=jbase.is_info)[0]
    flat = []
    for path, leaf in got:
        if isinstance(leaf, dict):
            flat += [(f"{path}['{k}']", leaf[k]) for k in ("q", "s")]
        else:
            flat.append((path, leaf))
    assert all(isinstance(i, base.ParamInfo) for _, i in flat)
    assert [(p, i.shape, str(i.dtype).removeprefix("torch."), i.init) for p, i in flat] == \
        [(jax.tree_util.keystr(p), i.shape, np.dtype(i.dtype).name, i.init) for p, i in want]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-1b-a400m", "qwen1.5-4b"])
def test_abstract_quantized_params_describe_the_served_tree(arch):
    """The abstract tree's shapes and dtypes are those of
    `quantize_params_for_serving` on materialized weights."""
    cfg = configs.smoke(arch)
    params = base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu")
    served = dict(_leaves(apply.quantize_params_for_serving(cfg, params, min_size=0)))
    abstract = dict(_leaves(apply.abstract_quantized_params(cfg, min_size=0)))
    assert sorted(served) == sorted(abstract)
    for path, info in abstract.items():
        if isinstance(info, dict):
            for k in ("q", "s"):
                assert (tuple(served[path][k].shape), served[path][k].dtype) == \
                    (info[k].shape, info[k].dtype), path
        else:
            assert (tuple(served[path].shape), served[path].dtype) == (info.shape, info.dtype)
    nbytes = sum(math.prod(i.shape) * i.dtype.itemsize for _, t in abstract.items()
                 for i in (t.values() if isinstance(t, dict) else (t,)))
    assert nbytes < 4 * base.count_params(api.abstract_params(cfg))


def test_launcher_serves_granite_smoke(capsys):
    """`python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
    --smoke --device cpu`: the reference's summary line; `--w8` raises."""
    from repro_torch.launch import serve
    args = ["--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--new-tokens", "3"]
    out = serve.main(args)
    assert out.shape == (2, 3) and (out >= 0).all() and (out < 512).all()
    assert "generated 6 tokens in" in capsys.readouterr().out
    with pytest.raises(TypeError, match="repro/layers/moe.py:116"):
        serve.main(args + ["--w8"])
