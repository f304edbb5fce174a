"""Parity of the port's Mamba2 LM serving path with the JAX package's, on
the CPU, at `configs.smoke("mamba2-2.7b")` (2 layers, d_model 64, 8
heads of P=16, N=16, vocab 512).

Weights are made once by the JAX package and carried into the port with
`models.convert.from_jax_params`, so both sides compute the same thing.
The JAX mixer's kernel route runs its Pallas kernel in interpret mode.
Tolerances: 1e-4 absolute on fp32 paths (summation order of the same
fp32 algorithm); the bf16 serving case is stated at its test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.layers import mamba2 as jm2
from repro.models import api as japi
from repro.models import base as jbase
from repro.quantized import apply as japply
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.layers import mamba2 as m2
from repro_torch.models import api, base, convert
from repro_torch.quantized import apply
from repro_torch.serve.engine import Engine, ServeConfig

TOL = 1e-4
ARCH = "mamba2-2.7b"


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.smoke(ARCH), compute_dtype=dtype),
            dataclasses.replace(configs.smoke(ARCH), compute_dtype=dtype))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(0))
    pn = jax.tree.map(np.asarray, pj)
    return jcfg, cfg, pj, convert.from_jax_params(pn, device="cpu")


def _layer0(pj, pt):
    return (jax.tree.map(lambda t: t[0], pj["layers"]["mixer"]),
            {k: v[0] for k, v in pt["layers"]["mixer"].items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _hidden(seed, b, s, d=64):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def _prompts(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_mixer_matches_jax(model, use_kernel, return_state):
    """S = 128, a multiple of the mixer's chunk, as JAX's kernel route needs."""
    jcfg, cfg, pj, pt = model
    lj, lt = _layer0(pj, pt)
    x = _hidden(1, 2, 128)
    ssd_ops.reset_launches()
    got = m2.mamba_mixer(cfg, lt, torch.from_numpy(x), use_kernel=use_kernel,
                         return_state=return_state)
    want = jm2.mamba_mixer(jcfg, lj, jnp.asarray(x), use_kernel=use_kernel,
                           return_state=return_state)
    assert ssd_ops.ssd.launches == 0                 # the CPU takes the plain version
    if return_state:
        (got, state), (want, jstate) = got, want
        assert state["conv"].shape == (2, 3, jcfg.conv_dim)
        assert state["ssm"].shape == (2, 8, 16, 16) and state["ssm"].dtype == torch.float32
        _close(state["conv"].numpy(), jstate["conv"])
        _close(state["ssm"].numpy(), jstate["ssm"])
    assert got.shape == (2, 128, 64)
    _close(got.numpy(), want)


@pytest.mark.parametrize("s,chunk", [(100, 128), (100, 32), (37, 16)])
def test_ragged_kernel_route_equals_plain_route(model, s, chunk):
    """The kernel route zero-pads S to a chunk multiple; the padded rows
    have dt = 0, so y and the final state equal the unpadded scan, which
    the JAX non-kernel route computes."""
    jcfg, cfg, pj, pt = model
    lj, lt = _layer0(pj, pt)
    x = _hidden(s, 3, s)
    out_k, st_k = m2.mamba_mixer(cfg, lt, torch.from_numpy(x), chunk=chunk,
                                 use_kernel=True, return_state=True)
    out_p, st_p = m2.mamba_mixer(cfg, lt, torch.from_numpy(x), chunk=chunk,
                                 use_kernel=False, return_state=True)
    _close(out_k.numpy(), out_p.numpy())
    _close(st_k["ssm"].numpy(), st_p["ssm"].numpy())
    assert torch.equal(st_k["conv"], st_p["conv"])
    out_j, st_j = jm2.mamba_mixer(jcfg, lj, jnp.asarray(x), chunk=chunk, return_state=True)
    _close(out_k.numpy(), out_j)
    _close(st_k["ssm"].numpy(), st_j["ssm"])


def test_decode_step_matches_jax(model):
    jcfg, cfg, pj, pt = model
    lj, lt = _layer0(pj, pt)
    rng = np.random.default_rng(7)
    x = _hidden(8, 2, 1)
    cache = {"conv": rng.normal(size=(2, 3, jcfg.conv_dim)).astype(np.float32),
             "ssm": rng.normal(size=(2, 8, 16, 16)).astype(np.float32)}
    out, new = m2.mamba_decode_step(cfg, lt, torch.from_numpy(x),
                                    {k: torch.from_numpy(v) for k, v in cache.items()})
    out_j, new_j = jm2.mamba_decode_step(jcfg, lj, jnp.asarray(x),
                                         {k: jnp.asarray(v) for k, v in cache.items()})
    _close(out.numpy(), out_j)
    _close(new["conv"].numpy(), new_j["conv"])
    _close(new["ssm"].numpy(), new_j["ssm"])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_step_match_jax(model, use_kernel):
    jcfg, cfg, pj, pt = model
    toks = _prompts(3, 2, 40)
    cache = base.tree_init(api.abstract_cache(cfg, 2, 64), torch.Generator(), "cpu")
    logits, cache = api.prefill(cfg, pt, {"tokens": torch.from_numpy(toks).long()}, cache,
                                use_kernel=use_kernel)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 2, 64), jax.random.PRNGKey(0))
    logits_j, jcache = japi.prefill(jcfg, pj, {"tokens": jnp.asarray(toks)}, jcache)
    assert logits.shape == (2, 512)
    _close(logits.numpy(), logits_j)
    _close(cache["ssm"].numpy(), jcache["ssm"])
    _close(cache["conv"].numpy(), jcache["conv"])
    nxt = toks[:, -1:]
    logits, cache = api.decode_step(cfg, pt, torch.from_numpy(nxt).long(),
                                    torch.full((2,), 40), cache)
    logits_j, jcache = japi.decode_step(jcfg, pj, jnp.asarray(nxt), jnp.full((2,), 40), jcache)
    _close(logits.numpy(), logits_j)
    _close(cache["ssm"].numpy(), jcache["ssm"])


def test_forward_and_loss_match_jax(model):
    jcfg, cfg, pj, pt = model
    toks = _prompts(4, 2, 33)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss, _ = api.loss_fn(cfg, pt, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                          use_kernel=True)
    loss_j, _ = japi.loss_fn(jcfg, pj, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(loss_j)) < TOL


@pytest.mark.parametrize("w8", [False, True])
def test_engine_generates_jax_tokens(model, w8):
    jcfg, cfg, pj, pt = model
    if w8:
        pj = japply.quantize_params_for_serving(jcfg, pj, min_size=0)
        pt = apply.quantize_params_for_serving(cfg, pt, min_size=0)
    prompts = _prompts(5, 3, 24)
    ssd_ops.reset_launches()
    out = Engine(cfg, pt, ServeConfig(max_len=40, max_new_tokens=6),
                 device="cpu").generate(prompts)
    want = JEngine(jcfg, pj, JServeConfig(max_len=40, max_new_tokens=6)).generate(prompts)
    assert out.shape == (3, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, want)
    assert ssd_ops.ssd.launches == 0


def test_engine_bf16_close_to_jax():
    """Compute dtype bf16, as configured. The port's engine sends the SSD
    through the kernel route (dt cast to bf16 first), JAX's prefill through
    its fp32-dt route, and both round activations to bf16 at other places,
    so last-position logits agree to 0.1 absolute: logits here reach |4|,
    where a bf16 ulp is 0.0156, and the two differ by up to 2 ulps on three
    seeds; 0.1 leaves a margin of three. Greedy tokens must agree wherever
    JAX's top-2 margin exceeds twice that."""
    jcfg, cfg = _cfgs("bfloat16")
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(1))
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    toks = _prompts(6, 4, 48)
    cache = base.tree_init(api.abstract_cache(cfg, 4, 64), torch.Generator(), "cpu")
    logits, _ = api.prefill(cfg, pt, {"tokens": torch.from_numpy(toks).long()}, cache,
                            use_kernel=True)
    jcache = jbase.tree_init(japi.abstract_cache(jcfg, 4, 64), jax.random.PRNGKey(0))
    logits_j, _ = japi.prefill(jcfg, pj, {"tokens": jnp.asarray(toks)}, jcache)
    assert logits.dtype == torch.bfloat16
    lj = np.asarray(logits_j, np.float32)
    np.testing.assert_allclose(logits.float().numpy(), lj, atol=0.1, rtol=0)
    top2 = np.sort(lj, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 0.2
    out = Engine(cfg, pt, ServeConfig(max_len=64, max_new_tokens=1),
                 device="cpu").generate(toks)
    np.testing.assert_array_equal(out[sure, 0], lj.argmax(-1)[sure])


def test_engine_needs_a_device(model, monkeypatch):
    _, cfg, _, pt = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Engine(cfg, pt, ServeConfig())
    assert Engine(cfg, pt, ServeConfig(), device="cpu").device == torch.device("cpu")


def test_configs_and_abstract_tree():
    cfg = configs.get_config(ARCH)
    jcfg = jconfigs.get_config(ARCH)
    # every field of the reference; the port's one more, `norm_plus_one`,
    # is the reference's name switch (gemma's (1 + w) norm scale)
    for f in dataclasses.fields(jcfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.norm_plus_one is False
    assert (cfg.d_inner, cfg.ssm_heads, cfg.conv_dim) == (5120, 80, 5376)
    assert cfg.cdtype() == torch.bfloat16
    assert base.count_params(api.abstract_params(cfg)) == \
        jbase.count_params(japi.abstract_params(jcfg))
    small = configs.smoke(ARCH)
    assert {f.name: getattr(small, f.name) for f in dataclasses.fields(jcfg)} == \
        dataclasses.asdict(jconfigs.smoke(ARCH))
    for name in ("qwen2-vl-2b", "musicgen-medium"):      # every reference config
        got = configs.get_config(name)
        assert {f.name: getattr(got, f.name) for f in dataclasses.fields(jcfg)} == \
            dataclasses.asdict(jconfigs.get_config(name))
    with pytest.raises(KeyError, match="registered"):
        configs.get_config("mnist-fpga")                 # the paper's net, as there
    for name, family in (("zamba2-2.7b", "hybrid"), ("granite-moe-1b-a400m", "moe"),
                         ("qwen3-moe-30b-a3b", "moe")):
        assert configs.get_config(name).family == family
        assert api.abstract_params(dataclasses.replace(small, family=family))


def test_tree_init_is_seeded_and_follows_the_rules():
    cfg = configs.smoke(ARCH)
    tree = api.abstract_params(cfg)
    p1 = base.tree_init(tree, torch.Generator().manual_seed(0), "cpu")
    p2 = base.tree_init(tree, torch.Generator().manual_seed(0), "cpu")
    mix = p1["layers"]["mixer"]
    assert torch.equal(mix["in_proj"], p2["layers"]["mixer"]["in_proj"])
    assert torch.all(mix["d_skip"] == 1) and torch.all(mix["a_log"] == 0)
    # normal init: std = scale / sqrt(fan-in), fan-in dim 1 for stacked weights
    assert abs(float(mix["in_proj"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(mix["conv_w"].std()) - 0.5 / 2) < 0.05


def test_tree_init_and_from_jax_params_default_to_the_card(monkeypatch):
    """device=None means cuda:0, so without CUDA both raise instead of
    quietly building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = api.abstract_params(configs.smoke(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        base.tree_init(tree, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax_params({"w": np.zeros((2, 3), np.float32)})
    assert convert.from_jax_params({"w": np.ones(2, np.float32)},
                                   device="cpu")["w"].device.type == "cpu"


def test_launcher_serves_the_smoke_config(capsys):
    """`python -m repro_torch.launch.serve` on the CPU, fp32 and W8: the
    reference's summary line, and the W8 run announces its checkpoint."""
    from repro_torch.launch import serve
    for extra in ([], ["--w8"]):
        out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "20", "--new-tokens", "3", *extra])
        assert out.shape == (2, 3) and (out >= 0).all() and (out < 512).all()
        text = capsys.readouterr().out
        assert "generated 6 tokens in" in text
        assert ("W8-specialized" in text) == bool(extra)


def test_unported_features_raise():
    """What cannot run here raises: `compressed_psum` outside a mesh with
    its axis, and the training launcher's --multi-pod, whose 2x16x16 mesh
    needs 512 ranks (the reference fails on one device too). The vlm and
    audio modalities run in the ssm and hybrid families; their decode
    steps, which the reference gives no modality defaults, raise KeyError
    without extras there too."""
    from repro_torch.launch import train
    from repro_torch.optim import compression
    with pytest.raises(ValueError, match="active mesh"):
        compression.compressed_psum(torch.zeros(3), "pod", torch.zeros(3))
    with pytest.raises(RuntimeError, match="needs 512 ranks; this world has 1"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--multi-pod"])
    for arch in (ARCH, "zamba2-2.7b"):
        small = configs.smoke(arch)
        p = base.tree_init(api.abstract_params(small), torch.Generator(), "cpu")
        for modality in ("vlm", "audio"):
            cfg = dataclasses.replace(small, modality=modality)
            extras = {"pixel_embeds": torch.ones((1, 4, 64)),
                      "pixel_mask": torch.tensor([[True, False, True, False]]),
                      "frame_embeds": torch.ones((1, 4, 64))}
            logits, _ = api.forward(cfg, p, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                                             **extras})
            assert logits.shape == (1, 4, 512) and bool(torch.isfinite(logits).all())
            cache = base.tree_init(api.abstract_cache(cfg, 1, 8), torch.Generator(), "cpu")
            with pytest.raises(KeyError):
                api.decode_step(cfg, p, torch.zeros((1, 1), dtype=torch.long),
                                torch.zeros((1,), dtype=torch.int32), cache)


def test_serve_config_fields_equal_the_reference():
    """The port's ServeConfig has the reference's fields, in its order and
    with its defaults; decoding stays greedy, as there."""
    assert [(f.name, f.default) for f in dataclasses.fields(ServeConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JServeConfig)]
    sc = ServeConfig(64, 4, 0.0, -1, 0)
    assert (sc.temperature, sc.seed) == (0.0, 0)
    assert ServeConfig(temperature=0.0, seed=0) == ServeConfig()


def _overflowing_ssd_inputs(B=1, S=256, H=2, P=4, N=8, G=1, seed=3):
    """SSD inputs whose decay over a chunk of 128 passes exp's fp32 range:
    dt about 1 with a = -1 and -0.75 (the reference's init: a_log 0, dt
    a softplus of an O(1) projection, about 0.7 on average), so that
    exp(cum_q - cum_k) above the chunk's diagonal is inf."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (1.0 + 0.2 * rng.random((B, S, H))).astype(np.float32)
    a = np.array([-1.0, -0.75], np.float32)[:H]
    b, c = (rng.normal(size=(B, S, G, N)).astype(np.float32) for _ in range(2))
    ct = rng.normal(size=(B, S, H, P)).astype(np.float32)
    return x, dt, a, b, c, ct


def test_chunked_ssd_gradient_is_finite_where_the_decay_overflows():
    """The chunked route's intra-chunk decay exp(cum_q - cum_k) is masked
    below the diagonal. Masked after the exp (the reference's
    `jnp.where(tri, exp(diff), 0)`, and the port's before its repair), the
    entries above it overflow to inf, and their gradient, 0 x inf, is NaN
    in every input; masked before the exp (exp(-inf) = 0), the forward is
    the same and the gradient finite. Held to the JAX package's exact
    recurrence (`ssd_sequential_ref`, through lax.scan, whose decays are
    at most 1) per batch row and head: y and every input's gradient within
    1e-4 of their largest magnitude (another algorithm's fp32 sums: a's
    gradient, a sum over 256 positions, differs by 4e-5 relative, the
    others by under 1e-5, CPU run); and the reference mixer's chunked
    route (`repro.layers.mamba2._ssd_chunked_batch`) is shown to give NaN
    on these inputs."""
    from repro.kernels.ssd_scan import ref as jref
    x, dt, a, b, c, ct = _overflowing_ssd_inputs()
    B, S, H, P = x.shape
    rep = H // b.shape[2]
    ts = [torch.tensor(v, requires_grad=True) for v in (x, dt, a, b, c)]
    y, _ = m2._ssd_chunked_batch(*ts, chunk=128)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), ts)
    assert all(torch.isfinite(g).all() for g in grads)

    def loss(xh, dth, ah, bh, ch, cth):
        return jnp.sum(jref.ssd_sequential_ref(xh, dth, ah, bh, ch)[0] * cth)

    want_y = np.zeros_like(x)
    want = [np.zeros_like(v) for v in (x, dt, a, b, c)]
    for bi in range(B):
        for h in range(H):
            g = h // rep
            args = (x[bi, :, h], dt[bi, :, h], a[h], b[bi, :, g], c[bi, :, g], ct[bi, :, h])
            want_y[bi, :, h] = np.asarray(jref.ssd_sequential_ref(*args[:5])[0])
            gx, gdt, ga, gb, gc = jax.grad(loss, argnums=range(5))(*args)
            want[0][bi, :, h] += np.asarray(gx)
            want[1][bi, :, h] += np.asarray(gdt)
            want[2][h] += np.asarray(ga)
            want[3][bi, :, g] += np.asarray(gb)
            want[4][bi, :, g] += np.asarray(gc)
    # the reference mixer's chunked route (what its train step runs)
    ref = jax.grad(lambda *v: jnp.sum(jm2._ssd_chunked_batch(*v, chunk=128)[0] * ct),
                   argnums=range(5))(x, dt, a, b, c)
    assert any(np.isnan(np.asarray(g)).any() for g in ref)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0,
                               atol=TOL * np.abs(want_y).max())
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=TOL * np.abs(w).max())


def test_lm_gradient_is_finite_at_a_chunk_of_128():
    """The port's one-process train step of the smoke model at 256
    tokens (two chunks of 128, where the decay overflows exp's fp32 range
    above the diagonal): a finite loss and finite gradients."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train import step
    _, cfg = _cfgs()
    shape = base.ShapeConfig("s", 256, 2, "train", accum=1)
    params = base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, 0, seed=1).items()}
    loss, _, grads = step.make_grad_fn(cfg, shape, remat="full")(params, batch)
    assert torch.isfinite(loss)
    for path, g in base.tree_items(grads):
        assert torch.isfinite(g).all(), base.keystr(path)
