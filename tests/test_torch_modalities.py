"""Parity of the port's vlm and audio modalities with the JAX package's, on
the CPU, at the smoke size: `assemble_inputs`, `forward`, `prefill` and
`decode_step`, and `Engine.generate` with numpy extras, in the dense
family (qwen2-vl-2b, musicgen-medium as configured) and in the ssm and
hybrid families switched to each modality (mamba2-2.7b, zamba2-2.7b).

Weights are made by the JAX package and carried into the port with
`models.convert.from_jax_params`; extras come from the data pipeline
(`make_batch`, numpy), the same arrays on both sides. Tolerance: 1e-5
absolute and relative in fp32 (the sinusoidal positions' sin/cos differ
by an fp32 ulp between XLA and torch); the bf16 case states its bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.layers import embedding as jemb
from repro.models import api as japi
from repro.models import base as jbase
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.layers import embedding
from repro_torch.models import api, base, convert
from repro_torch.serve.engine import Engine, ServeConfig

TOL = 1e-5
# (family, modality) -> (arch whose smoke config is used, modality to set)
CASES = {"dense-vlm": ("qwen2-vl-2b", "vlm"), "dense-audio": ("musicgen-medium", "audio"),
         "ssm-vlm": ("mamba2-2.7b", "vlm"), "ssm-audio": ("mamba2-2.7b", "audio"),
         "hybrid-vlm": ("zamba2-2.7b", "vlm"), "hybrid-audio": ("zamba2-2.7b", "audio")}
EXTRA_KEYS = ("pixel_embeds", "pixel_mask", "positions", "frame_embeds")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than eight that contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, modality, dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), modality=modality, compute_dtype=dtype)
    cfg = dataclasses.replace(configs.smoke(arch), modality=modality, compute_dtype=dtype)
    return jcfg, cfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


def _batch(jcfg, seq, batch=2, step=0):
    """A make_batch batch: tokens, targets and the modality's extras."""
    return jpipeline.make_batch(jcfg, jbase.ShapeConfig("t", seq, batch, "train"), step, seed=3)


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    arch, modality = CASES[request.param]
    jcfg, cfg = _cfgs(arch, modality)
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, pj, convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.mark.parametrize("arch,modality", [("qwen2-vl-2b", "vlm"),
                                           ("musicgen-medium", "audio")])
def test_assemble_inputs_match_jax(arch, modality):
    """The backbone input: patch embeddings where the mask is set (vlm);
    frame embeddings plus sinusoidal positions, given or arange (audio)."""
    jcfg, cfg = _cfgs(arch, modality)
    pj = jbase.tree_init(jemb.embed_params(jcfg), jax.random.PRNGKey(2))
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    b = _batch(jcfg, 12)
    b.pop("targets"), b.pop("loss_mask", None)
    variants = [b]
    if modality == "audio":       # positions given: a continuation at 40
        variants.append({**b, "positions": np.broadcast_to(
            np.arange(40, 52, dtype=np.int32), (2, 12)).copy()})
    for v in variants:
        got = embedding.assemble_inputs(cfg, pt, _t(v))
        want = jax.jit(lambda p, x: jemb.assemble_inputs(jcfg, p, x))(pj, v)
        assert got.shape == (2, 12, 64) and got.dtype == torch.float32
        _close(got.numpy(), want)
    if modality == "vlm":        # image positions carry the patch embeddings
        np.testing.assert_array_equal(got[:, :3].numpy(), b["pixel_embeds"][:, :3])


def test_forward_and_loss_match_jax(model):
    jcfg, cfg, pj, pt = model
    b = _batch(jcfg, 16)
    logits, _ = api.forward(cfg, pt, _t(b))
    logits_j, _ = jax.jit(lambda p, x: japi.forward(jcfg, p, x))(pj, b)
    assert logits.shape == (2, 16, 512)
    _close(logits.numpy(), logits_j)
    loss, metrics = api.loss_fn(cfg, pt, _t(b))
    loss_j, metrics_j = jax.jit(lambda p, x: japi.loss_fn(jcfg, p, x))(pj, b)
    assert sorted(metrics) == sorted(metrics_j)
    _close(float(loss), float(loss_j))


def test_prefill_and_decode_steps_match_jax(model):
    """Prefill with the prompt's extras; two decode steps given explicit
    one-position extras (zero embeddings, a false mask; M-RoPE and audio
    positions at the step), the same arrays on both sides."""
    jcfg, cfg, pj, pt = model
    b = _batch(jcfg, 12)
    pre = {k: v for k, v in b.items() if k not in ("targets", "loss_mask")}
    cache = base.tree_init(api.abstract_cache(cfg, 2, 20), torch.Generator(), "cpu")
    logits, cache = api.prefill(cfg, pt, _t(pre), cache)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 2, 20), jax.random.PRNGKey(0))
    logits_j, jcache = jax.jit(lambda p, x, c: japi.prefill(jcfg, p, x, c))(pj, pre, jcache)
    _close(logits.numpy(), logits_j)
    jstep = jax.jit(lambda p, t, ps, c, e: japi.decode_step(jcfg, p, t, ps, c, e))
    for step in range(2):
        pos = np.full((2,), 12 + step, np.int32)
        nxt = np.asarray(logits_j).argmax(-1)[:, None].astype(np.int32)
        extras = ({"pixel_embeds": np.zeros((2, 1, 64), np.float32),
                   "pixel_mask": np.zeros((2, 1), bool)} if cfg.modality == "vlm" else
                  {"frame_embeds": np.full((2, 1, 64), 0.01 * step, np.float32),
                   "positions": pos[:, None]})
        logits, cache = api.decode_step(cfg, pt, torch.from_numpy(nxt).long(),
                                        torch.from_numpy(pos), cache, _t(extras))
        logits_j, jcache = jstep(pj, nxt, pos, jcache, extras)
        _close(logits.numpy(), logits_j)
    for (_, got), (_, want) in zip(base.tree_items(cache),
                                   jax.tree_util.tree_flatten_with_path(jcache)[0]):
        _close(got.float().numpy(), want)


def test_decode_step_defaults_match_jax(model):
    """Without extras, the transformer's decode_step supplies the
    reference's defaults (no patch, zero frames at position pos); the ssm
    and hybrid families supply none, and raise KeyError in both packages."""
    jcfg, cfg, pj, pt = model
    cache = base.tree_init(api.abstract_cache(cfg, 2, 8), torch.Generator(), "cpu")
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 2, 8), jax.random.PRNGKey(0))
    toks, pos = np.array([[3], [9]], np.int32), np.array([0, 0], np.int32)
    if cfg.family != "dense":
        with pytest.raises(KeyError):
            api.decode_step(cfg, pt, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                            cache)
        with pytest.raises(KeyError):
            japi.decode_step(jcfg, pj, jnp.asarray(toks), jnp.asarray(pos), jcache)
        return
    logits, _ = api.decode_step(cfg, pt, torch.from_numpy(toks).long(),
                                torch.from_numpy(pos), cache)
    logits_j, _ = japi.decode_step(jcfg, pj, jnp.asarray(toks), jnp.asarray(pos), jcache)
    _close(logits.numpy(), logits_j)


def test_engine_serves_numpy_extras_like_jax(model):
    """`Engine.generate(prompts, extras)` with the pipeline's numpy extras
    moves them to the engine's device with their dtypes and serves the
    reference's tokens; a family whose decode_step supplies no defaults
    raises KeyError in both packages, as the reference's launcher does."""
    jcfg, cfg, pj, pt = model
    b = _batch(jcfg, 12, batch=3, step=4)
    extras = {k: v for k, v in b.items() if k in EXTRA_KEYS}
    sc, jsc = ServeConfig(max_len=24, max_new_tokens=5), JServeConfig(max_len=24,
                                                                      max_new_tokens=5)
    engine, jengine = Engine(cfg, pt, sc, device="cpu"), JEngine(jcfg, pj, jsc)
    if cfg.family != "dense":
        with pytest.raises(KeyError):
            engine.generate(b["tokens"], extras)
        with pytest.raises(KeyError):
            jengine.generate(b["tokens"], extras)
        return
    out = engine.generate(b["tokens"], extras)
    want = jengine.generate(b["tokens"], extras)
    assert out.shape == (3, 5) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)
    # tensors are accepted as they are
    np.testing.assert_array_equal(engine.generate(b["tokens"], _t(extras)), want)


def test_engine_bf16_vlm_close_to_jax():
    """Compute dtype bf16, as configured (qwen2-vl's smoke): prefill's last
    logits within the dense tests' bf16 bound, 0.1 absolute (a bf16 ulp is
    0.0156 at |4|), and greedy tokens equal wherever JAX's top-2 margin
    exceeds twice that."""
    jcfg, cfg = _cfgs("qwen2-vl-2b", "vlm", "bfloat16")
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(1))
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    b = _batch(jcfg, 24, batch=4, step=2)
    pre = {k: v for k, v in b.items() if k not in ("targets", "loss_mask")}
    cache = base.tree_init(api.abstract_cache(cfg, 4, 32), torch.Generator(), "cpu")
    logits, _ = api.prefill(cfg, pt, _t(pre), cache)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 4, 32), jax.random.PRNGKey(0))
    lj = np.asarray(japi.prefill(jcfg, pj, pre, jcache)[0], np.float32)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), lj, atol=0.1, rtol=0)
    top2 = np.sort(lj, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 0.2
    out = Engine(cfg, pt, ServeConfig(max_len=32, max_new_tokens=1), device="cpu").generate(
        b["tokens"], {k: v for k, v in pre.items() if k != "tokens"})
    np.testing.assert_array_equal(out[sure, 0], lj.argmax(-1)[sure])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_modality_configs_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    fields = [f.name for f in dataclasses.fields(jcfg)]
    assert {f: getattr(cfg, f) for f in fields} == dataclasses.asdict(jcfg)
    assert cfg.norm_plus_one is False
    assert base.count_params(api.abstract_params(cfg)) == \
        jbase.count_params(japi.abstract_params(jcfg))
    small = configs.smoke(arch)
    assert {f: getattr(small, f) for f in fields} == dataclasses.asdict(jconfigs.smoke(arch))
