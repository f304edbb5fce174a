"""Parity of the port's optimizer, gradient compression and data stream
with the JAX package's, on the CPU, and the port's counterparts of
`tests/test_optim_and_data.py`.

`apply_updates` is held on identical gradients: both packages take the
same fp32 parameters, moments and gradients, and must agree to 1e-6
relative, elementwise, plus 1e-6 of each leaf's largest magnitude: the
reference's order of operations, but XLA on the CPU contracts
`b1 * m + (1 - b1) * g` into a fused multiply-add, which rounds once
where torch rounds twice, and an element where the two terms cancel
keeps an absolute error of an ulp of the terms, not of the result. Adam turns a near-zero gradient's
sign into a full +-lr step, so trajectories from independently computed
gradients are not compared here (tests/test_torch_train.py holds those
through losses and gradients). int8 compression: the int8 values equal,
the scales within an fp32 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep (requirements.txt); stub keeps suite collectable
    from _hypothesis_stub import given, settings, strategies as st

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import base as jbase
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import api, base, convert
from repro_torch.optim import adamw, compression

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than eight that contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oc(**kw):
    return adamw.OptConfig(**kw), jadamw.OptConfig(**kw)


def _tree(seed, scale=1.0):
    """A small parameter-shaped tree of fp32 numpy arrays (nested dicts)."""
    rng = np.random.default_rng(seed)
    return {"embed": {"tok": (rng.normal(size=(16, 8)) * scale).astype(np.float32)},
            "layers": {"w": (rng.normal(size=(2, 8, 8)) * scale).astype(np.float32),
                       "b": (rng.normal(size=(2, 8)) * scale).astype(np.float32)},
            "final": (rng.normal(size=(8,)) * scale).astype(np.float32)}


def _t(tree):
    return convert.from_jax_params(tree, device="cpu")


@pytest.mark.parametrize("kw", [dict(lr=1.0, warmup_steps=10, total_steps=110),
                                dict(lr=3e-4, warmup_steps=2, total_steps=6),
                                dict(lr=1e-3, warmup_steps=0, total_steps=50,
                                     min_lr_ratio=0.0)],
                         ids=["long", "chip", "no-warmup"])
def test_schedule_matches_jax(kw):
    oc, joc = _oc(**kw)
    for t in range(0, kw["total_steps"] + 20, 3):
        got = float(adamw.schedule(oc, torch.tensor(t, dtype=torch.int32)))
        want = float(jadamw.schedule(joc, jnp.asarray(t, jnp.int32)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), t
    assert float(adamw.schedule(oc, 1)) == pytest.approx(
        float(jadamw.schedule(joc, jnp.asarray(1))), rel=RTOL)


def test_schedule_warmup_cosine():
    oc = adamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    s = lambda t: float(adamw.schedule(oc, torch.tensor(t)))
    assert s(0) == 0.0
    assert abs(s(10) - 1.0) < 0.11
    assert s(110) <= 0.1 + 1e-6 or abs(s(110) - 0.1) < 1e-5
    assert s(5) < s(10)


def test_global_norm_matches_jax():
    g = _tree(1, scale=3.0)
    got = float(adamw.global_norm(_t(g)))
    assert got == pytest.approx(float(jadamw.global_norm(g)), rel=RTOL)


@pytest.mark.parametrize("clip", [1e9, 1.0, 0.05], ids=["no-clip", "clip-1", "clip-0.05"])
def test_apply_updates_matches_jax_on_identical_gradients(clip):
    """Four steps, each feeding both packages the same gradients: the
    parameters, moments, step and metrics agree to 1e-6 relative."""
    oc, joc = _oc(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=clip)
    p0 = _tree(2)
    zeros = jax.tree.map(np.zeros_like, p0)
    jstate = (p0, {"m": zeros, "v": zeros, "step": np.zeros((), np.int32)})
    params = _t(p0)
    opt = {"m": _t(zeros), "v": _t(zeros), "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(lambda p, g, o: jadamw.apply_updates(p, g, o, joc))
    for s in range(4):
        g = _tree(10 + s, scale=0.5)
        jp, jo, jm = jstep(jstate[0], g, jstate[1])
        jstate = (jp, jo)
        params, opt, metrics = adamw.apply_updates(params, _t(g), opt, oc)
        assert int(opt["step"]) == int(jo["step"]) == s + 1
        for k in ("grad_norm", "lr"):
            assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=RTOL)
        for tree, jtree in ((params, jp), (opt["m"], jo["m"]), (opt["v"], jo["v"])):
            for (_, a), (_, b) in zip(base.tree_items(tree),
                                      jax.tree_util.tree_flatten_with_path(jtree)[0]):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                           atol=RTOL * float(np.abs(b).max()))


def test_apply_updates_works_in_place():
    """The state is updated where it lies and returned: a full-width state
    is held once."""
    oc = adamw.OptConfig(lr=0.1, warmup_steps=0)
    params = {"w": torch.ones(3)}
    opt = {"m": {"w": torch.zeros(3)}, "v": {"w": torch.zeros(3)},
           "step": torch.zeros((), dtype=torch.int32)}
    w, m = params["w"], opt["m"]["w"]
    new_p, new_opt, _ = adamw.apply_updates(params, {"w": torch.ones(3)}, opt, oc)
    assert new_p is params and new_opt is opt and new_p["w"] is w and new_opt["m"]["w"] is m
    assert torch.all(w < 1) and torch.all(m > 0) and int(opt["step"]) == 1


def test_adamw_converges_quadratic():
    oc = adamw.OptConfig(lr=0.1, warmup_steps=0, total_steps=1000, weight_decay=0.0,
                         clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = {"m": {"w": torch.zeros(2)}, "v": {"w": torch.zeros(2)},
           "step": torch.zeros((), dtype=torch.int32)}
    for _ in range(300):
        params, opt, _ = adamw.apply_updates(params, {"w": 2 * params["w"]}, opt, oc)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_applied():
    oc = adamw.OptConfig(lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    opt = {"m": {"w": torch.zeros(4)}, "v": {"w": torch.zeros(4)},
           "step": torch.zeros((), dtype=torch.int32)}
    _, opt, metrics = adamw.apply_updates(params, {"w": torch.full((4,), 100.0)}, opt, oc)
    assert float(metrics["grad_norm"]) > 100.0       # reported before the clip
    # the moments saw the clipped gradient: |g| = 1 over 4 elements
    np.testing.assert_allclose(opt["m"]["w"].numpy(), 0.1 * 0.5, rtol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m", "zamba2-2.7b"])
def test_abstract_opt_state_matches_jax(arch):
    """m and v mirror the parameter tree in fp32; step is an int32 scalar."""
    tree = adamw.abstract_opt_state(api.abstract_params(configs.smoke(arch)))
    jtree = jadamw.abstract_opt_state(japi.abstract_params(jconfigs.smoke(arch)))
    got = [(base.keystr(p), i.shape, str(i.dtype).split(".")[-1], i.init)
           for p, i in base.tree_items(tree)]
    want = [(jax.tree_util.keystr(p), i.shape, str(np.dtype(i.dtype)), i.init)
            for p, i in jax.tree_util.tree_flatten_with_path(jtree, is_leaf=jbase.is_info)[0]]
    assert got == want


@pytest.mark.parametrize("n", [1, 2047, 2048, 5000])
def test_int8_quantization_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32) * 10
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jcompression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == (-(-n // 2048), 2048)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    back = compression.dequantize_int8(q, s, (n,), torch.float32)
    np.testing.assert_array_max_ulp(back.numpy(), np.asarray(
        jcompression.dequantize_int8(jq, js, (n,), jnp.float32)), maxulp=1)


def test_compress_decompress_matches_jax():
    rng = np.random.default_rng(0)
    err, jerr = torch.zeros(3000), jnp.zeros((3000,), jnp.float32)
    for _ in range(5):
        g = rng.normal(size=(3000,)).astype(np.float32)
        sent, err = compression.compress_decompress(torch.from_numpy(g), err)
        jsent, jerr = jcompression.compress_decompress(jnp.asarray(g), jerr)
        np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-6, atol=1e-7)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 5000), seed=st.integers(0, 2**31 - 1))
def test_int8_compression_bounded_error(n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32) * 10)
    q, s = compression.quantize_int8(x)
    back = compression.dequantize_int8(q, s, x.shape, torch.float32)
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-5


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(0)
    err = torch.zeros(1024)
    total_true = np.zeros(1024, np.float32)
    total_sent = np.zeros(1024, np.float32)
    for _ in range(50):
        g = rng.normal(size=(1024,)).astype(np.float32)
        sent, err = compression.compress_decompress(torch.from_numpy(g), err)
        total_true += g
        total_sent += sent.numpy()
    resid = np.abs(total_true - total_sent).max()
    one_step = np.abs(g).max() / 127 * 4
    assert resid < one_step * 3, (resid, one_step)


def test_compressed_psum_waits_for_meshes():
    with pytest.raises(NotImplementedError, match="A.7"):
        compression.compressed_psum(torch.zeros(4), "data", torch.zeros(4))


def test_data_deterministic_and_resumable():
    cfg = configs.smoke("qwen1.5-4b")
    shape = base.ShapeConfig("smoke", 16, 4, "train")
    b1 = pipeline.make_batch(cfg, shape, step=5, seed=9)
    np.testing.assert_array_equal(b1["tokens"],
                                  pipeline.make_batch(cfg, shape, step=5, seed=9)["tokens"])
    assert not np.array_equal(b1["tokens"],
                              pipeline.make_batch(cfg, shape, step=6, seed=9)["tokens"])
    it = pipeline.batch_iterator(cfg, shape, seed=9, start_step=5)
    s, b = next(it)
    assert s == 5
    np.testing.assert_array_equal(b["tokens"], b1["tokens"])
    assert next(it)[0] == 6


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-2b", "musicgen-medium"])
def test_batch_iterator_equals_the_reference(arch):
    from repro.data import pipeline as jpipeline
    jcfg = jconfigs.smoke(arch)
    shape = jbase.ShapeConfig("smoke", 12, 2, "train")
    got = pipeline.batch_iterator(configs.smoke(arch),
                                  base.ShapeConfig(**dataclasses.asdict(shape)), seed=4,
                                  start_step=3)
    want = jpipeline.batch_iterator(jcfg, shape, seed=4, start_step=3)
    for _ in range(3):
        (s, b), (js, jb) = next(got), next(want)
        assert s == js and sorted(b) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(b[k], jb[k])


def test_data_has_learnable_structure():
    cfg = configs.smoke("qwen1.5-4b")
    b = pipeline.make_batch(cfg, base.ShapeConfig("smoke", 128, 8, "train"), step=0, seed=1)
    pred = (b["tokens"].astype(np.int64) * (31337 % cfg.vocab) + 17) % cfg.vocab
    assert (pred == b["targets"]).mean() > 0.8
