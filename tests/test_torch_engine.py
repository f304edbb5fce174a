"""The port's async serving engine against the JAX package's, on the CPU.

Admission and rejection (unknown versions, bad input, a full queue, an
engine that is closed), deadlines that expire in the queue, drain and
fail-fast shutdown, no leaked batcher thread, a dispatch failure that
fails only its batch, and N producers x M versions under seeded Poisson
load whose answers equal the JAX package's `jnp` target and
`predict_quantized`, with no future lost or duplicated. Every wait is
bounded: a regression fails, it does not hang.
"""
import gc
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import netgen as jnetgen
from repro.core import quantize as jquantize
from repro_torch import netgen
from repro_torch.core import quantize
from repro_torch.netgen import targets, telemetry
from repro_torch.netgen.engine import (
    DeadlineExceededError, EngineClosedError, QueueFullError, ServingEngine,
)

from _netgen_helpers import images, random_net

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "benchmarks"))
from check_trace import (  # noqa: E402
    check_launches, check_metrics, check_spans, parse_prometheus,
)

SIZES = (12, 9, 4)


def _jnet(seed: int, sizes=SIZES):
    return random_net(seed, sizes, lo=-5, hi=5)


def _net(seed: int, sizes=SIZES):
    return quantize.from_numpy(_jnet(seed, sizes).weights)


def _images(seed: int, b: int, n_in: int = SIZES[0]) -> np.ndarray:
    return images(seed, b, n_in, salt=55)


def _ref(jnet, x):
    return np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x)))


def _engine(target="torch", **kw):
    return ServingEngine(session=netgen.Session(device="cpu"), target=target, **kw)


def _engine_threads():
    return [t for t in threading.enumerate() if t.name.startswith("netgen-engine")]


def _register_fake(monkeypatch, name: str, description: str, compile_fn):
    """Register a test-only target for the length of one test: the
    registry is process-wide, and a leftover name would show up in
    every later `list_targets()`."""
    monkeypatch.setitem(targets._REGISTRY, name, netgen.Target(
        name=name, kind="callable", description=description, compile=compile_fn))


def _gated_target(monkeypatch, name: str):
    """A callable fake target whose artifacts block on `gate` and flag
    `in_call`: the deterministic way to hold the batcher inside a
    dispatch while a test inspects the queue."""
    gate, in_call = threading.Event(), threading.Event()

    def compile_gated(circuit, *, device):
        def artifact(x):
            in_call.set()
            assert gate.wait(10.0), "test gate never released"
            return torch.zeros((np.asarray(x).shape[0],), dtype=torch.int32,
                               device=device)
        return artifact

    _register_fake(monkeypatch, name, "test-only gated predictor", compile_gated)
    return gate, in_call


# ---------------------------------------------------------------------------
# Admission semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["torch", "cuda[planes=true]", "fused"])
def test_submit_resolves_futures_exactly(target):
    jnet = _jnet(0)
    with _engine(target, slot_capacity=8, max_batch_delay=0.001) as eng:
        art = eng.register("v", quantize.from_numpy(jnet.weights))
        xs = _images(1, 20)
        futs = [eng.submit("v", x) for x in xs]
        got = np.array([f.result(timeout=30) for f in futs])
        np.testing.assert_array_equal(got, art(xs).numpy())
        np.testing.assert_array_equal(got, _ref(jnet, xs))
        assert eng.infer("v", xs[0], timeout=30) == int(_ref(jnet, xs[:1])[0])
        assert eng.versions() == ["v"] and eng.scope.startswith("engine-")
    st = eng.stats()
    assert st.submitted == st.completed == 21
    assert st.queue_depth == 0 and st.batches >= 1
    assert not _engine_threads()


def test_submit_rejects_unknown_version_and_bad_input():
    with _engine(slot_capacity=4) as eng:
        eng.register("v", _net(1))
        with pytest.raises(KeyError):
            eng.submit("nope", _images(2, 1)[0])
        with pytest.raises(ValueError):          # batches go to NetServer
            eng.submit("v", _images(2, 3))
        with pytest.raises(TypeError):           # non-uint8
            eng.submit("v", _images(2, 1)[0].astype(np.float32))
        with pytest.raises(ValueError):          # wrong width
            eng.submit("v", _images(2, 1, n_in=5)[0])
    assert eng.stats().submitted == 0


def test_engine_construction():
    with pytest.raises(ValueError):
        _engine(max_batch_delay=-1.0)
    with pytest.raises(ValueError):
        _engine(max_queue_depth=0)
    server = netgen.NetServer(cache=netgen.CompileCache(device="cpu"), slot_capacity=2)
    with pytest.raises(ValueError):              # server XOR session/target
        ServingEngine(server, target="torch")
    with ServingEngine(server) as eng:
        assert eng.server is server
        assert (eng.max_batch_delay, eng.max_queue_depth) == (0.002, 4096)
    with netgen.Session(device="cpu", capacity=8) as sess:
        with sess.engine(target="cuda", slot_capacity=4, max_batch_delay=0.0) as eng:
            assert eng.server.cache is sess.cache and eng.server.device == sess.device
            eng.register("v", _net(2))
            assert sess.stats().misses == 1
            assert eng.infer("v", _images(3, 1)[0], timeout=30) in range(SIZES[-1])
            eng.unregister("v")
            assert eng.versions() == []


def test_engine_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServingEngine(target="cuda[planes=true]")
    with pytest.raises(RuntimeError):
        ServingEngine()
    assert not _engine_threads()


# ---------------------------------------------------------------------------
# SLO knobs: queue bound, deadlines
# ---------------------------------------------------------------------------

def test_queue_full_rejection_is_explicit(monkeypatch):
    gate, in_call = _gated_target(monkeypatch, "gatedfake_qfull")
    gate.set()                                   # let warmup through
    eng = _engine("gatedfake_qfull", slot_capacity=1, max_batch_delay=0.0,
                  max_queue_depth=2)
    try:
        eng.register("v", _net(3))
        gate.clear()
        in_call.clear()
        x = _images(4, 1)[0]
        first = eng.submit("v", x)               # batcher blocks in dispatch
        assert in_call.wait(10.0)
        q1, q2 = eng.submit("v", x), eng.submit("v", x)   # fill the queue
        assert eng.queue_depth() == 2
        with pytest.raises(QueueFullError):
            eng.submit("v", x)
        assert eng.stats().rejected_queue_full == 1
        gate.set()
        assert [f.result(timeout=10) for f in (first, q1, q2)] == [0, 0, 0]
    finally:
        gate.set()
        eng.shutdown(timeout=10)
    assert not _engine_threads()


@pytest.mark.parametrize("deadline", [1e-4, 0.0])
def test_deadline_expired_in_queue_is_rejected(deadline):
    """A long batch delay and a slot capacity far above the load hold the
    requests in the queue past the tight deadline."""
    jnet = _jnet(5)
    with _engine("cuda[fusednet=true]", slot_capacity=64, max_batch_delay=0.25) as eng:
        eng.register("v", quantize.from_numpy(jnet.weights))
        xs = _images(6, 4)
        doomed = eng.submit("v", xs[0], deadline=deadline)
        live = [eng.submit("v", x) for x in xs[1:]]
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=10)
        got = np.array([f.result(timeout=10) for f in live])
        np.testing.assert_array_equal(got, _ref(jnet, xs[1:]))
    st = eng.stats()
    assert (st.rejected_deadline, st.completed) == (1, 3)


# ---------------------------------------------------------------------------
# Shutdown: drain vs fail-fast, closed admission, no thread leak
# ---------------------------------------------------------------------------

def test_shutdown_drains_accepted_requests():
    jnet = _jnet(7)
    eng = _engine("cuda[packed=true]", slot_capacity=4, max_batch_delay=0.2)
    eng.register("v", quantize.from_numpy(jnet.weights))
    xs = _images(8, 6)
    futs = [eng.submit("v", x) for x in xs]
    eng.shutdown(timeout=30)                     # drain=True default
    got = np.array([f.result(timeout=1) for f in futs])
    np.testing.assert_array_equal(got, _ref(jnet, xs))
    with pytest.raises(EngineClosedError):
        eng.submit("v", xs[0])
    assert eng.stats().rejected_closed == 1
    eng.shutdown()                               # idempotent
    assert not _engine_threads()


def test_shutdown_without_drain_fails_pending(monkeypatch):
    gate, in_call = _gated_target(monkeypatch, "gatedfake_drain")
    gate.set()
    eng = _engine("gatedfake_drain", slot_capacity=1, max_batch_delay=0.0,
                  max_queue_depth=64)
    try:
        eng.register("v", _net(9))
        gate.clear()
        in_call.clear()
        x = _images(10, 1)[0]
        inflight = eng.submit("v", x)            # blocks inside dispatch
        assert in_call.wait(10.0)
        queued = eng.submit("v", x)              # still in the queue
        eng.shutdown(drain=False, timeout=0.2)   # thread still gated: ok
        with pytest.raises(EngineClosedError):
            queued.result(timeout=1)
        assert eng.stats().rejected_closed == 1
    finally:
        gate.set()
    assert inflight.result(timeout=10) == 0      # in-flight work completes
    eng.shutdown(timeout=10)
    assert not _engine_threads()


def test_dropped_engine_leaks_no_threads():
    eng = _engine(slot_capacity=4, max_batch_delay=0.0)
    eng.register("v", _net(11))
    assert eng.infer("v", _images(12, 1)[0], timeout=30) in range(SIZES[-1])
    (thread,) = _engine_threads()
    assert thread.name == f"netgen-engine-{eng.scope}"
    del eng
    gc.collect()
    deadline = time.time() + 5.0
    while _engine_threads() and time.time() < deadline:
        time.sleep(0.01)
    assert not _engine_threads(), "batcher thread leaked after GC"


def test_dispatch_failure_fails_only_its_batch(monkeypatch):
    """A predictor that raises fails the futures of its batch; the
    batcher keeps serving the next one."""
    calls = {"n": 0}

    def compile_flaky(circuit, *, device):
        def artifact(x):
            calls["n"] += 1
            if calls["n"] == 2:                  # after the warmup: the 1st batch
                raise RuntimeError("injected dispatch failure")
            return torch.ones((np.asarray(x).shape[0],), dtype=torch.int32)
        return artifact

    _register_fake(monkeypatch, "flakyfake", "test-only failing predictor", compile_flaky)
    with _engine("flakyfake", slot_capacity=8, max_batch_delay=0.05) as eng:
        eng.register("v", _net(13))
        x = _images(14, 3)
        doomed = [eng.submit("v", r) for r in x]
        for f in doomed:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=10)
        assert eng.infer("v", x[0], timeout=10) == 1
    st = eng.stats()
    assert (st.submitted, st.completed, st.batches) == (4, 1, 2)


# ---------------------------------------------------------------------------
# N producers x M versions, seeded Poisson load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["cuda[planes=true]", "torch"])
def test_poisson_load_equals_jax_no_lost_futures(target):
    """4 producers x 60 requests over 3 versions, exponential gaps:
    every answer equals JAX's `jnp` target and `predict_quantized`, every
    future resolves exactly once, and the batches stacked the versions."""
    telemetry.enable()
    telemetry.reset()
    m, producers, per_producer = 3, 4, 60
    jnets = {f"v{i}": _jnet(20 + i) for i in range(m)}
    jserver = jnetgen.NetServer(target="jnp", slot_capacity=8)
    try:
        with _engine(target, slot_capacity=8, max_batch_delay=0.002,
                     max_queue_depth=1 << 14) as eng:
            for v, jnet in jnets.items():
                eng.register(v, quantize.from_numpy(jnet.weights))
                jserver.register(v, jnet)
            results: list[list] = [[] for _ in range(producers)]

            def producer(k: int) -> None:
                rng = np.random.default_rng(1000 + k)
                for _ in range(per_producer):
                    v = f"v{rng.integers(0, m)}"
                    x = _images(int(rng.integers(1 << 16)), 1)[0]
                    results[k].append((v, x, eng.submit(v, x)))
                    time.sleep(float(rng.exponential(0.0005)))

            threads = [threading.Thread(target=producer, args=(k,))
                       for k in range(producers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            assert not any(t.is_alive() for t in threads)
            flat = [r for rs in results for r in rs]
            assert len(flat) == producers * per_producer
            assert len({id(f) for _, _, f in flat}) == len(flat)
            for v in jnets:
                mine = [(x, fut) for w, x, fut in flat if w == v]
                xs = np.stack([x for x, _ in mine])
                got = np.array([fut.result(timeout=30) for _, fut in mine])
                np.testing.assert_array_equal(got, jserver.predict(v, xs))
                np.testing.assert_array_equal(got, _ref(jnets[v], xs))
            assert all(fut.done() and fut.exception() is None for _, _, fut in flat)
            scope = eng.server._scope
        st = eng.stats()
        assert st.submitted == st.completed == producers * per_producer
        assert (st.rejected_queue_full, st.rejected_deadline, st.rejected_closed) == (0, 0, 0)
        assert st.queue_depth == 0 and st.batches < st.submitted
        assert not _engine_threads()
        reg = telemetry.get_registry()
        rows = reg.histogram("netgen_engine_batch_rows", engine=eng.scope)
        wait = reg.histogram("netgen_engine_queue_wait_seconds", engine=eng.scope)
        assert rows.count == st.batches and rows.sum == st.completed
        assert wait.count == st.completed and wait.p50 <= wait.p99
        assert reg.counter("netgen_dispatch_total", server=scope, path="stacked").value > 0
        spans = {r.span_id: r for r in reg.spans()}
        batches = [r for r in spans.values() if r.name == "netgen.engine.batch"]
        assert len(batches) == st.batches
        for r in spans.values():
            if r.name == "netgen.dispatch" and r.thread.startswith("netgen-engine"):
                assert spans[r.parent_id].name == "netgen.engine.batch"
        samples = parse_prometheus(telemetry.prometheus())
        dicts = [r.as_dict() for r in spans.values()]
        assert check_metrics(samples) == []
        assert check_spans(dicts, require=("netgen.engine.batch", "netgen.dispatch",
                                           "netgen.kernel")) == []
        assert check_launches(dicts, samples) == []
    finally:
        telemetry.disable()
        telemetry.reset()
