"""Parity of the port's compiler half (`repro_torch.netgen` up to the
ExecutionPlan, and `repro_torch.core`) with the JAX package's.

Frontend, passes, plans, bit-planes, megakernel views and stacked plans
must produce identical arrays; digests, pass statistics and pipeline
fingerprints must be equal. Everything here is numpy, so every
comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro import netgen as jnetgen
from repro.core import dataset as jdataset
from repro.core import quantize as jquantize
from repro.netgen.plan import lower_circuit as jlower_circuit
from repro.netgen.plan import stack_plans as jstack_plans
from repro.serve.slots import pad_slots as jpad_slots
from repro_torch import netgen
from repro_torch.core import dataset, quantize
from repro_torch.netgen.plan import lower_circuit, stack_plans
from repro_torch.netgen.targets import resolve_target
from repro_torch.serve.slots import pad_slots

from _netgen_helpers import random_net

SIZES = [(40, 6), (45, 21, 7), (33, 40, 12, 5), (64, 32, 10)]


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _sparse_net(seed, sizes):
    """A net with zero terms and dead hidden units for the passes."""
    net = random_net(seed, sizes, lo=-3, hi=3)
    ws = [w.copy() for w in net.weights]
    ws[0][:, ::3] = 0                       # empty accumulators
    if len(ws) > 1:
        ws[1][1::4, :] = 0                  # hidden units nothing reads
    return jquantize.QuantizedNet(weights=ws)


def _port(net):
    return quantize.from_numpy(net.weights, net.input_threshold)


def _assert_same_plan(p, q):
    assert (p.n_inputs, p.input_threshold, p.packed, p.bitplanes, p.n_models,
            p.form) == (q.n_inputs, q.input_threshold, q.packed, q.bitplanes,
                        q.n_models, q.form)
    assert len(p.layers) == len(q.layers)
    for i, (a, b) in enumerate(zip(p.layers, q.layers)):
        assert (a.activation, a.words, a.n_planes) == \
            (b.activation, b.words, b.n_planes), i
        _assert_same(a.weights, b.weights, f"layer {i} weights")
        if a.pos_planes is not None or b.pos_planes is not None:
            _assert_same(a.pos_planes, b.pos_planes, f"layer {i} pos")
            _assert_same(a.neg_planes, b.neg_planes, f"layer {i} neg")


def _assert_same_view(v, w):
    assert (v.n_inputs, v.input_threshold, v.n_classes, v.n_models,
            v.layer_words, v.layer_planes, v.layer_fan_out) == \
        (w.n_inputs, w.input_threshold, w.n_classes, w.n_models,
         w.layer_words, w.layer_planes, w.layer_fan_out)
    assert len(v.arrays) == len(w.arrays)
    for i, (a, b) in enumerate(zip(v.arrays, w.arrays)):
        _assert_same(a, b, f"view array {i}")


@pytest.mark.parametrize("sizes", SIZES)
def test_plan_planes_and_view_identical(sizes):
    jnet = _sparse_net(len(sizes), sizes)
    jc, jstats = jnetgen.PipelineSpec.coerce("default").run(jnetgen.lower(jnet))
    c, stats = netgen.PipelineSpec.coerce("default").run(netgen.lower(_port(jnet)))
    assert [(s.name, vars(s.before), vars(s.after)) for s in stats] == \
        [(s.name, vars(s.before), vars(s.after)) for s in jstats]
    jplan, plan = jlower_circuit(jc), lower_circuit(c)
    _assert_same_plan(plan, jplan)
    _assert_same_plan(plan.pack(), jplan.pack())
    _assert_same_plan(plan.planes(), jplan.planes())
    _assert_same_view(plan.megakernel_view(), jplan.megakernel_view())


def test_stack_plans_identical():
    sizes = ((20, 13, 5), (20, 16, 5), (20, 19, 5))
    jnets = [_sparse_net(30 + i, s) for i, s in enumerate(sizes)]
    jplan = jstack_plans([
        jlower_circuit(jnetgen.PipelineSpec.coerce(None).run(
            jnetgen.lower(n))[0]) for n in jnets])
    plan = stack_plans([
        lower_circuit(netgen.PipelineSpec.coerce(None).run(
            netgen.lower(_port(n)))[0]) for n in jnets])
    _assert_same_plan(plan, jplan)
    _assert_same_plan(plan.planes(), jplan.planes())
    _assert_same_view(plan.megakernel_view(), jplan.megakernel_view())
    with pytest.raises(ValueError):
        stack_plans([lower_circuit(netgen.lower(_port(random_net(1, (20, 5))))),
                     lower_circuit(netgen.lower(_port(random_net(2, (20, 4)))))])


def test_addend_rewrite_stats_identical():
    jnet = _sparse_net(4, (30, 9, 4))
    spec = "zeros,prune,addends"
    _, jstats = jnetgen.PipelineSpec.parse(spec).run(jnetgen.lower(jnet))
    c, stats = netgen.PipelineSpec.parse(spec).run(netgen.lower(_port(jnet)))
    assert [(s.name, vars(s.before), vars(s.after)) for s in stats] == \
        [(s.name, vars(s.before), vars(s.after)) for s in jstats]
    assert stats[-1].after.mults == 0
    # addend form stays a regular circuit: its plan equals the pruned one's
    pruned, _ = netgen.PipelineSpec.parse("zeros,prune").run(
        netgen.lower(_port(jnet)))
    _assert_same_plan(lower_circuit(c), lower_circuit(pruned))


def test_digest_and_from_numpy_round_trip():
    jnet = random_net(7, (12, 9, 4))
    net = _port(jnet)
    assert net.digest() == jnet.digest()
    assert quantize.weights_digest(net.weights) == \
        jquantize.weights_digest(jnet.weights)
    for a, b in zip(net.weights, jnet.weights):
        _assert_same(a, b, "weights")
    other = quantize.from_numpy(jnet.weights, input_threshold=64)
    assert other.digest() != net.digest()
    assert other.input_threshold == 64 and net.shapes == jnet.shapes
    with pytest.raises(TypeError):
        quantize.weights_digest([np.ones((2, 2), np.float32)])


def test_params_from_numpy_quantize_identical():
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(12, 7)).astype(np.float32),
              "w2": rng.normal(size=(7, 3)).astype(np.float32)}
    port = quantize.quantize(quantize.params_from_numpy(params))
    ref = jquantize.quantize(params)
    assert port.digest() == ref.digest()


def test_predict_quantized_matches_reference():
    import jax.numpy as jnp
    jnet = random_net(8, (30, 11, 5))
    x = np.random.default_rng(8).integers(0, 256, (13, 30)).astype(np.uint8)
    want = np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x)))
    got = quantize.predict_quantized(_port(jnet), device="cpu")(x)
    np.testing.assert_array_equal(got.numpy(), want)


def _wrapping_net():
    """w1 4x2 with column 0 all 2**30 (its accumulator wraps to 0 on four
    set pixels) and column 1 all 1; w2 [[5, 0], [0, 1]]; threshold 127."""
    w1 = np.ones((4, 2), np.int64)
    w1[:, 0] = 2 ** 30
    w2 = np.array([[5, 0], [0, 1]], np.int32)
    return jquantize.QuantizedNet(weights=[w1.astype(np.int32), w2], input_threshold=127)


def test_predict_quantized_wraps_like_the_reference():
    """The accumulators wrap to int32 as JAX's int32 products do: four
    pixels of 255 make hidden unit 0 sum to 2**32, which wraps to 0, so
    class 1 wins; the ids are int32, as JAX returns them."""
    import jax.numpy as jnp
    jnet = _wrapping_net()
    x = np.full((1, 4), 255, np.uint8)
    want = np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x)))
    got = quantize.predict_quantized(_port(jnet), device="cpu")(x)
    assert want.tolist() == [1] and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("target", ["torch", "cuda", "cuda[packed=true]", "cuda[planes=true]",
                                    "cuda[fusednet=true]", "fused"])
def test_every_target_wraps_like_predict_quantized(target, monkeypatch):
    """The range analysis proves this net overflows int32, so a strict
    compile raises (as JAX's does); in the production posture the compile
    proceeds and every target wraps like `predict_quantized`."""
    jnet = _wrapping_net()
    x = np.full((1, 4), 255, np.uint8)
    with pytest.raises(netgen.VerificationError, match="range.int32"):
        netgen.Session(device="cpu").compile(_port(jnet), target=target)
    monkeypatch.setenv("NETGEN_VERIFY", "0")
    got = netgen.Session(device="cpu").compile(_port(jnet), target=target)(x)
    np.testing.assert_array_equal(
        got.numpy(), quantize.predict_quantized(_port(jnet), device="cpu")(x).numpy())
    assert got.tolist() == [1]


def test_pipeline_spec_strings_and_errors():
    for spec in ("default", "zeros,prune", "prune,addends", "zeros,prune,addends",
                 "cse"):
        p, q = netgen.PipelineSpec.coerce(spec), jnetgen.PipelineSpec.coerce(spec)
        assert p.spec_string() == q.spec_string()
        assert p.fingerprint() == q.fingerprint()
        assert netgen.PipelineSpec.parse(p.spec_string()) == p
    for bad in ("zeros,zeros", "retime", "zeros[budget=2]", "", "zeros,,prune"):
        with pytest.raises(ValueError):
            netgen.PipelineSpec.coerce(bad)


def test_targets_declare_only_ported_options():
    t, opts = resolve_target("cuda[planes=true,bm=8]")
    assert t.name == "cuda" and opts == {"planes": True, "bm": 8}
    t, opts = resolve_target("cuda[packed=true,bn=64]")
    assert t.name == "cuda" and opts == {"packed": True, "bn": 64}
    t, opts = resolve_target("fused[bm=4]")
    assert t.name == "fused" and opts == {"bm": 4} and t.compile_multi is None
    # tuned and explored are ported; bkw is declared on cuda only so that
    # its compile raises the backend's error naming the deviation
    t, opts = resolve_target("cuda[tuned=true,explored=true,bkw=8]")
    assert opts == {"tuned": True, "explored": True, "bkw": 8} and t.wants_tuner
    t, opts = resolve_target("fused[tuned=true]")
    assert opts == {"tuned": True} and t.wants_tuner
    with pytest.raises(ValueError, match="bkw has no counterpart"):
        netgen.Session(device="cpu").compile(_port(random_net(0, (12, 9, 4))),
                                             target="cuda[bkw=8]")
    for bad in ("cuda[interpret=false]", "cuda[planes=3]", "torch[planes=true]",
                "torch[tuned=true]", "fused[bkw=8]", "fused[explored=true]",
                "fused[interpret=true]", "fused[bn=32]",
                "pallas", "verilog[bm=8]", "cost[style=x]"):
        with pytest.raises(ValueError):
            resolve_target(bad)
    assert [t.name for t in netgen.list_targets()] == \
        ["cost", "cuda", "fused", "torch", "verilog"]


@pytest.mark.parametrize("target,jtarget", [("cuda", "pallas"),
                                            ("cuda[packed=true]", "pallas[packed=true]")])
@pytest.mark.parametrize("wide", [False, True])
def test_chain_holds_int8_weights_when_the_net_fits(target, jtarget, wide):
    """The dense and packed chains hold int8 weights (the tensor-core
    route) when every layer fits int8, else int32 (one |w| = 200 is
    enough); either way the answers equal JAX's Pallas target in
    interpret mode and `predict_quantized`."""
    import jax.numpy as jnp
    import torch
    from repro_torch.netgen.backends import cuda

    jnet = random_net(70, (45, 21, 7), lo=-9, hi=9)
    if wide:
        ws = [w.copy() for w in jnet.weights]
        ws[1][3, 2] = 200
        jnet = jquantize.QuantizedNet(weights=ws)
    plan = lower_circuit(netgen.lower(_port(jnet)))
    plan = plan.pack() if "packed" in target else plan
    arrays, _ = cuda._chain(plan, {}, torch.device("cpu"))
    assert {a.dtype for a in arrays} == {torch.int32 if wide else torch.int8}
    x = np.random.default_rng(70).integers(0, 256, (19, 45)).astype(np.uint8)
    got = netgen.Session(device="cpu").compile(_port(jnet), target=target)(x).numpy()
    jart = jnetgen.Session().compile(jnet, target=jtarget)
    np.testing.assert_array_equal(got, np.asarray(jart(jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x))))


@pytest.mark.parametrize("stacked", [False, True])
def test_planes_chain_holds_k_major_planes(stacked):
    """The `cuda[planes=true]` chain holds every plane K-major
    (`plane_mma_weights`, the 1-bit tensor cores' layout), single and
    stacked; built on the CPU, its answers equal `predict_quantized` and
    JAX's `pallas[planes=true]` target in interpret mode."""
    import jax.numpy as jnp
    import torch
    from repro_torch.netgen.backends import cuda

    jnets = [random_net(80 + i, (45, 21, 7), lo=-9, hi=9) for i in range(3 if stacked else 1)]
    plans = [lower_circuit(netgen.lower(_port(j))) for j in jnets]
    plan = (stack_plans(plans) if stacked else plans[0]).planes()
    arrays, run = cuda._chain(plan, {}, torch.device("cpu"))
    for a, want in zip(arrays, [p for l in plan.layers for p in (l.pos_planes, l.neg_planes)]):
        assert a.shape == want.shape and a.stride(-2) == 1 and a.stride(-1) % 8 == 0
        np.testing.assert_array_equal(a.numpy().view(np.uint32), want)
    x = np.random.default_rng(80).integers(0, 256, (19, 45)).astype(np.uint8)
    for m, jnet in enumerate(jnets):
        ws = [a[m] for a in arrays] if stacked else arrays
        got = run(torch.from_numpy(x), *ws).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x))))
    got = netgen.Session(device="cpu").compile(_port(jnets[0]), target="cuda[planes=true]")(x)
    jart = jnetgen.Session().compile(jnets[0], target="pallas[planes=true]")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jart(jnp.asarray(x))))


def test_frontend_threshold_validation():
    net = random_net(3, (8, 3))
    for thr in (-1, 255, 1.5, True):
        with pytest.raises((TypeError, ValueError)):
            netgen.lower(net.weights, input_threshold=thr)
    with pytest.raises(ValueError):
        netgen.lower([np.ones((3, 2), np.float32)])


def test_dataset_and_slots_copies_identical():
    for n, seed in ((5, 0), (12, 3)):
        for a, b in zip(dataset.make_dataset(n, seed), jdataset.make_dataset(n, seed)):
            _assert_same(a, b, "dataset")
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)
    (pa, na), (pb, nb) = pad_slots(x, 5), jpad_slots(x, 5)
    assert na == nb
    _assert_same(pa, pb, "pad_slots")
    with pytest.raises(ValueError):
        pad_slots(x, 2)
