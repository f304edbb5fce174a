"""The port's telemetry registry against the JAX package's, on the CPU.

The same operations on a fresh `Registry()` of each package give the
same Prometheus text, `summary()` metrics and percentiles; the port's
compile / store / serve lifecycle reports the reference's metric names,
label keys and span names, and its traces pass the stdlib-only gate
`benchmarks/check_trace.py` (`check_spans`, `check_metrics`,
`check_launches`) unchanged. Every backend call counts its kernel
launches as the reference's does, and `jit_cost` counts a predictor's
operations and bytes from its plan.
"""
import dataclasses
import gc
import json
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
from repro.netgen import telemetry as jtelemetry
from repro_torch import netgen
from repro_torch.core import quantize
from repro_torch.netgen import graph, telemetry

from _netgen_helpers import images, random_net

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "benchmarks"))
from check_trace import (  # noqa: E402
    check_launches, check_metrics, check_spans, check_trace_dir,
    parse_prometheus,
)

SIZES = (12, 9, 4)


@pytest.fixture(autouse=True)
def _clean_registry():
    """Each test starts with zeroed metrics and no retained spans, and
    leaves tracing disabled for the rest of the suite."""
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _jnet(seed: int, sizes=SIZES):
    return random_net(seed, sizes, lo=-5, hi=5)


def _net(seed: int, sizes=SIZES):
    return quantize.from_numpy(_jnet(seed, sizes).weights)


def _x(seed: int, b: int, n_in: int = SIZES[0]) -> np.ndarray:
    return images(seed, b, n_in, salt=77)


def _ref(jnet, x):
    return np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x)))


def _session(**kw):
    return netgen.Session(device="cpu", **kw)


# Module-level passes, so the dotted-name form can import them.
def identity_pass(circuit):
    return circuit


def double_last_layer(circuit):
    """Doubles every weight of the last layer: widens the class scores'
    value interval, which the per-pass verifier refuses."""
    last = circuit.depth
    nodes = tuple(
        dataclasses.replace(n, terms=tuple(
            graph.Term(weight=2 * t.weight, src=t.src) for t in n.terms))
        if isinstance(n, graph.WeightedSum) and n.layer == last else n
        for n in circuit.nodes)
    return dataclasses.replace(circuit, nodes=nodes)


# ---------------------------------------------------------------------------
# The registry: the same operations give the same exports in both packages
# ---------------------------------------------------------------------------

def _drive(reg, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(int(rng.integers(3, 9))):
        reg.counter("demo_total", kind=f"k{i % 3}").inc(int(rng.integers(0, 5)))
        reg.gauge("demo_level", shard=str(i % 2)).set(float(rng.normal()))
    for v in rng.exponential(0.01, size=int(rng.integers(1, 400))):
        reg.histogram("demo_seconds", server="s", version="v").observe(v)
    for v in rng.integers(1, 257, size=50):
        reg.histogram("demo_rows").observe(int(v))
    reg.gauge("quoted", v='say "hi"\n').add(2)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_registries_export_identically(seed):
    mine, ref = telemetry.Registry(hist_window=64), jtelemetry.Registry(hist_window=64)
    _drive(mine, seed)
    _drive(ref, seed)
    assert mine.prometheus() == ref.prometheus()
    assert mine.summary() == ref.summary()
    assert mine.report() == ref.report()
    for q in (0.01, 0.5, 0.95, 0.99, 1.0):
        assert mine.histogram("demo_seconds", server="s", version="v").percentile(q) == \
            ref.histogram("demo_seconds", server="s", version="v").percentile(q)
    assert check_metrics(parse_prometheus(mine.prometheus())) == []


def test_histogram_exact_percentiles():
    h = telemetry.Histogram("h", {})
    for v in range(1, 101):                  # 1..100, shuffled in
        h.observe(((v * 37) % 100) + 1)
    assert (h.count, h.p50, h.p95, h.p99, h.percentile(1.0)) == (100, 50, 95, 99, 100)
    assert h.mean == pytest.approx(50.5)
    assert telemetry.Histogram("e", {}).p50 == 0.0
    with pytest.raises(ValueError):
        h.percentile(0.0)
    w = telemetry.Histogram("w", {}, window=8)
    for v in range(100):
        w.observe(v)
    assert (w.count, w.sum, w.percentile(1.0), w.p50) == (100, sum(range(100)), 99, 95)


def test_counter_thread_hammer():
    c = telemetry.Counter("c", {})
    n_threads, per_thread = 8, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [c.inc() for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c.value == n_threads * per_thread


def test_registry_get_or_create_reset_and_scopes():
    reg = telemetry.Registry()
    a, b, c = (reg.counter("x_total", k="1"), reg.counter("x_total", k="1"),
               reg.counter("x_total", k="2"))
    assert a is b and a is not c
    a.inc(3)
    reg.reset()                              # zeroes in place: handles stay valid
    a.inc()
    assert reg.counter("x_total", k="1").value == 1
    s1, s2 = telemetry.new_scope("probe"), telemetry.new_scope("probe")
    assert s1 != s2 and s1.startswith("probe-")


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

def test_span_nesting_threads_errors_and_jsonl(tmp_path):
    reg = telemetry.Registry()
    with reg.span("off", a=1) as sp:         # disabled: a shared no-op
        sp.set_attr("b", 2)
    assert reg.spans() == []
    reg.enabled = True
    with reg.span("outer", kind="test"):
        with reg.span("inner"):
            pass
        t = threading.Thread(target=lambda: reg.span("worker").__enter__().__exit__(
            None, None, None))
        t.start()
        t.join(10.0)
    with pytest.raises(RuntimeError):
        with reg.span("boom"):
            raise RuntimeError("x")
    by_name = {r.name: r for r in reg.spans()}
    assert by_name["inner"].parent_id == by_name["outer"].span_id
    assert by_name["inner"].trace_id == by_name["outer"].trace_id
    assert by_name["worker"].parent_id is None        # roots its own trace
    assert by_name["boom"].error == "RuntimeError"
    path = tmp_path / "t.jsonl"
    assert reg.export_jsonl(path) == 4
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert check_spans(lines, require=("outer", "inner", "worker")) == []
    assert reg.summary()["format"] == jtelemetry.get_registry().summary()["format"] \
        == "netgen-trace-v1"


# ---------------------------------------------------------------------------
# Pipelines: dotted and partial passes, spans, verify failures
# ---------------------------------------------------------------------------

def _pipelines(ng, mod):
    return [
        [ng.delete_zero_terms, ng.prune_dead_units],
        [functools_partial(ng.share_common_addends, max_new_nodes=2)],
        [ng.delete_zero_terms, getattr(mod, "identity_pass")],
        "zeros,test_torch_telemetry.identity_pass",
        [ng.delete_zero_terms, functools_partial(
            ng.share_common_addends, max_new_nodes=4, bucketed=True)],
    ]


def functools_partial(fn, **kw):
    import functools
    return functools.partial(fn, **kw)


@pytest.mark.parametrize("case", range(5))
def test_dotted_and_partial_passes_match_the_reference(case):
    mod = sys.modules[__name__]
    mine = netgen.PipelineSpec.coerce(_pipelines(netgen, mod)[case])
    ref = jnetgen.PipelineSpec.coerce(_pipelines(jnetgen, mod)[case])
    assert mine.spec_string() == ref.spec_string()
    assert mine.fingerprint() == ref.fingerprint()
    assert netgen.PipelineSpec.parse(mine.spec_string()) == mine
    assert netgen.PipelineSpec.from_passes(mine.build()) == mine
    jnet = _jnet(30)
    c, stats = mine.run(netgen.lower(_net(30)))
    jc, jstats = ref.run(jnetgen.lower(jnet))
    assert [s.row() for s in stats] == [s.row() for s in jstats]
    x = _x(30, 9)
    np.testing.assert_array_equal(netgen.evaluate(c, x), jnetgen.evaluate(jc, x))


def test_lambdas_closures_and_bad_partials_are_refused():
    def closure(c):
        return c

    lam = lambda c: c  # noqa: E731 — the refused form itself
    for bad in ([lam], [closure]):
        with pytest.raises(ValueError) as mine:
            netgen.PipelineSpec.coerce(bad)
        with pytest.raises(ValueError) as ref:
            jnetgen.PipelineSpec.coerce(bad)
        assert str(mine.value) == str(ref.value)
        assert "lambdas and closures have no stable fingerprint" in str(mine.value)
    with pytest.raises(ValueError) as mine:
        netgen.PipelineSpec.coerce([netgen.delete_zero_terms] * 2)
    with pytest.raises(ValueError) as ref:
        jnetgen.PipelineSpec.coerce([jnetgen.delete_zero_terms] * 2)
    assert str(mine.value) == str(ref.value)
    for ng in (netgen, jnetgen):
        with pytest.raises(ValueError, match="has no declared option"):
            ng.PipelineSpec.coerce([functools_partial(ng.share_common_addends, depth=2)])
        with pytest.raises(ValueError, match="not importable"):
            ng.PipelineSpec.parse("mypkg.passes.retime")


def test_pipeline_spans_and_verify_failures():
    telemetry.enable()
    spec = netgen.PipelineSpec.coerce("zeros,prune")
    spec.run(netgen.lower(_net(31)))
    spans = telemetry.get_registry().spans()
    (pipe,) = [r for r in spans if r.name == "netgen.pipeline"]
    passes = [r for r in spans if r.name == "netgen.pass"]
    assert pipe.attrs == {"pipeline": "zeros,prune", "steps": 2}
    assert [p.attrs["name"] for p in passes] == ["zeros", "prune"]
    for p in passes:
        assert p.parent_id == pipe.span_id
        assert p.attrs["terms_after"] <= p.attrs["terms_before"]
    bad = netgen.PipelineSpec.coerce([double_last_layer])
    with pytest.raises(netgen.VerificationError):
        bad.run(netgen.lower(_net(31)), verify=True)
    failures = telemetry.counter("netgen_verify_failures_total", phase="pipeline")
    assert failures.value >= 1


def test_compile_counts_verify_failures_in_production(monkeypatch):
    """A net whose accumulator overflows int32 fails the range proof: the
    strict posture raises, the production posture counts
    `netgen_verify_failures_total{phase=compile}` and compiles anyway,
    and the reference counts the same."""
    w1 = np.ones((4, 2), np.int32)
    w1[:, 0] = 2 ** 30
    jnet = jquantize.QuantizedNet(weights=[w1, np.array([[5, 0], [0, 1]], np.int32)],
                                  input_threshold=127)
    net = quantize.from_numpy(jnet.weights, 127)
    with pytest.raises(netgen.VerificationError, match="range.int32"):
        _session(capacity=0).compile(net, target="torch")
    monkeypatch.setenv("NETGEN_VERIFY", "0")
    mine = telemetry.counter("netgen_verify_failures_total", phase="compile")
    ref = jtelemetry.counter("netgen_verify_failures_total", phase="compile")
    m0, r0 = mine.value, ref.value
    art = _session(capacity=0).compile(net, target="torch")
    jnetgen.Session(capacity=0).compile(jnet, target="jnp")
    assert mine.value - m0 == ref.value - r0 >= 1
    assert art(np.full((1, 4), 255, np.uint8)).tolist() == [1]


# ---------------------------------------------------------------------------
# Backends: launch counters and jit_cost
# ---------------------------------------------------------------------------

PAIRS = [("cuda", "pallas", "dense"), ("cuda[packed=true]", "pallas[packed=true]", "packed"),
         ("cuda[planes=true]", "pallas[planes=true]", "planes"),
         ("cuda[fusednet=true]", "pallas[fusednet=true]", "fusednet"),
         ("fused", "fused", "fused")]


@pytest.mark.parametrize("target,jtarget,form", PAIRS)
def test_kernel_launch_counters_match_the_reference(target, jtarget, form):
    jnet = _jnet(40)
    x = _x(40, 6)
    art = _session().compile(_net(40), target=target)
    jart = jnetgen.Session().compile(jnet, target=jtarget)
    mine, ref = telemetry.kernel_launches(form), jtelemetry.kernel_launches(form)
    m0, r0 = mine.value, ref.value
    for _ in range(3):
        np.testing.assert_array_equal(art(x).numpy(), np.asarray(jart(jnp.asarray(x))))
    assert mine.value - m0 == ref.value - r0 == 3 * art.artifact.launches_per_call


@pytest.mark.parametrize("target,jtarget,form", PAIRS[:4])
def test_stacked_launch_counters_match_the_reference(target, jtarget, form):
    jnets = [_jnet(41 + i) for i in range(3)]
    plans = [netgen.lower_circuit(netgen.PipelineSpec.coerce(None).run(
        netgen.lower(quantize.from_numpy(j.weights)))[0]) for j in jnets]
    jplans = [jnetgen.lower_circuit(jnetgen.PipelineSpec.coerce(None).run(
        jnetgen.lower(j))[0]) for j in jnets]
    fn = netgen.backends.compile_multi(netgen.stack_plans(plans), backend=target,
                                       device=torch.device("cpu"))
    jfn = jnetgen.backends.compile_multi(jnetgen.stack_plans(jplans), backend=jtarget)
    assert (fn.datapath, fn.launches_per_call) == (jfn.datapath, jfn.launches_per_call)
    mine = telemetry.kernel_launches(fn.datapath)
    ref = jtelemetry.kernel_launches(jfn.datapath)
    m0, r0 = mine.value, ref.value
    x = np.stack([_x(50 + i, 5) for i in range(3)])
    np.testing.assert_array_equal(fn(x).numpy(), np.asarray(jfn(jnp.asarray(x))))
    assert mine.value - m0 == ref.value - r0 == fn.launches_per_call


@pytest.mark.parametrize("target", ["cuda", "cuda[planes=true]", "cuda[fusednet=true]",
                                    "fused"])
def test_jit_cost_counts_from_the_plan(target):
    art = _session().compile(_net(42), target=target)
    plan = art.plan()
    held = art.artifact.weight_bytes
    assert held > 0
    macs = sum(l.fan_in * l.fan_out for l in plan.layers)
    cost = telemetry.jit_cost(art.artifact, (8, SIZES[0]))
    assert cost == {"flops": 8.0 * 2 * macs,
                    "bytes_accessed": float(8 * SIZES[0] + held + 8 * 4)}
    stacked = telemetry.jit_cost(art.artifact, (3, 8, SIZES[0]))
    assert stacked["flops"] == 3 * cost["flops"]


def test_jit_cost_degrades_to_none():
    torch_art = _session().compile(_net(43), target="torch")
    assert telemetry.jit_cost(torch_art.artifact, (8, SIZES[0])) is None
    assert telemetry.jit_cost(len, (8, 12)) is None
    cuda = _session().compile(_net(43), target="cuda").artifact
    for shape in ((12,), ("x", 3), None, (8, -1)):
        assert telemetry.jit_cost(cuda, shape) is None
    assert telemetry.jit_cost(cuda, (8, 12), dtype="float64") is None


def test_profile_records_cost_analysis_and_gauges():
    telemetry.enable(profile=True)
    art = _session().compile(_net(44), target="cuda[planes=true]")
    want = telemetry.jit_cost(art.artifact, (8, SIZES[0]))
    assert art.timings["cost_analysis"] == want
    assert telemetry.gauge("netgen_artifact_flops", target="cuda").value == want["flops"]
    assert telemetry.gauge("netgen_artifact_bytes", target="cuda").value == \
        want["bytes_accessed"]
    telemetry.enable(profile=False)
    assert "cost_analysis" not in _session().compile(_net(45), target="cuda").timings


# ---------------------------------------------------------------------------
# The instrumented lifecycle: compile -> store -> serve
# ---------------------------------------------------------------------------

def test_compile_trace_nests_like_the_reference():
    telemetry.enable()
    jtelemetry.enable()
    try:
        jtelemetry.reset()
        _session(capacity=4).compile(_net(0), target="cuda[planes=true]")
        jnetgen.Session(capacity=4).compile(_jnet(0), target="pallas[planes=true]")

        def tree(reg):
            spans = {r.span_id: r for r in reg.spans()}
            return sorted((r.name, spans[r.parent_id].name if r.parent_id else None)
                          for r in spans.values())
        assert tree(telemetry.get_registry()) == tree(jtelemetry.get_registry())
    finally:
        jtelemetry.disable()
        jtelemetry.reset()
    (c,) = [r for r in telemetry.get_registry().spans() if r.name == "netgen.compile"]
    assert c.attrs["target"] == "cuda[planes=true]" and c.attrs["pipeline"] == "zeros,prune"
    assert telemetry.histogram("netgen_compile_seconds", target="cuda").count == 1


def test_store_and_cache_counters_route_through_registry(tmp_path):
    store = netgen.ArtifactStore(tmp_path / "store")
    _session(store=store, capacity=4).compile(_net(1), target="cuda")
    assert store.stats.saves == 1
    s2 = _session(store=store, capacity=4)
    s2.compile(_net(1), target="cuda")
    st = s2.stats()
    assert (st.compiles, st.store_hits) == (0, 1)
    assert store.stats.loads == 1 and store.stats.load_seconds > 0
    prom = telemetry.prometheus()
    assert "netgen_store_saves_total" in prom and "netgen_cache_store_hits_total" in prom
    assert check_metrics(parse_prometheus(prom)) == []


def test_compile_cache_concurrent_hammer():
    cache = netgen.CompileCache(capacity=8, device="cpu")
    net = _net(2)
    n_threads, per_thread = 8, 10
    errors = []

    def work():
        try:
            for _ in range(per_thread):
                cache.get_or_compile(net, backend="cuda[planes=true]")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    st = cache.stats()
    assert st.hits + st.misses == n_threads * per_thread
    assert st.compiles == st.misses == 1


def _server_with(jnets, target="cuda[fusednet=true]"):
    server = netgen.NetServer(cache=netgen.CompileCache(capacity=8, device="cpu"),
                              target=target, slot_capacity=8, warmup=False)
    for i, jnet in enumerate(jnets):
        server.register(f"v{i}", quantize.from_numpy(jnet.weights))
    return server


def _hammer(server, reqs, n_threads, per_thread):
    errors = []

    def work():
        try:
            for _ in range(per_thread):
                server.predict_many(reqs)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads) and not errors


@pytest.mark.parametrize("stackable", [True, False])
def test_concurrent_serving_invariants(stackable):
    telemetry.enable()
    jnets = [_jnet(3), _jnet(4) if stackable else random_net(5, (12, 10, 6, 4), lo=-5, hi=5)]
    server = _server_with(jnets)
    reqs = {"v0": _x(0, 13), "v1": _x(1, 13)}
    n_threads, per_thread = 6, 4
    _hammer(server, reqs, n_threads, per_thread)
    n = n_threads * per_thread
    path = "stacked" if stackable else "fallback"
    assert server.dispatch_counts == {"single": 0, "stacked": n * stackable, "sharded": 0,
                                      "fallback": n * (not stackable)}
    reg = telemetry.get_registry()
    for v in ("v0", "v1"):
        h = reg.histogram("netgen_predict_latency_seconds", server=server._scope, version=v)
        assert h.count == n and h.p50 <= h.p99
    occ = reg.histogram("netgen_slot_occupancy", server=server._scope)
    assert 0.0 < occ.percentile(0.01) <= occ.percentile(1.0) <= 1.0
    spans = {r.span_id: r for r in reg.spans()}
    kernels = [r for r in spans.values() if r.name == "netgen.kernel"]
    assert kernels
    for k in kernels:
        assert spans[k.parent_id].name == "netgen.dispatch"
        assert spans[k.parent_id].attrs["path"] == path
        assert k.attrs["form"] == "fusednet"
    if not stackable:
        assert server.stack_report(("v0", "v1")).reason == "stack.depth"
        assert reg.counter("netgen_stack_incompat_total", server=server._scope,
                           reason="stack.depth").value == 1
    samples = parse_prometheus(telemetry.prometheus())
    dicts = [r.as_dict() for r in spans.values()]
    assert check_spans(dicts, require=("netgen.dispatch", "netgen.kernel")) == []
    assert check_metrics(samples) == [] and check_launches(dicts, samples) == []


# ---------------------------------------------------------------------------
# Session executor lifecycle
# ---------------------------------------------------------------------------

def _compile_threads():
    return [t for t in threading.enumerate() if t.name.startswith("netgen-compile")]


def test_session_context_manager_joins_executor():
    with _session(capacity=4) as session:
        art = session.compile_async(_net(6), target="cuda").result(timeout=60)
        assert art.kind == "callable" and _compile_threads()
    assert not _compile_threads()
    session.shutdown()                       # idempotent


def test_dropped_session_leaks_no_threads():
    session = _session(capacity=4)
    session.compile_async(_net(7), target="cuda").result(timeout=60)
    assert _compile_threads()
    del session
    gc.collect()
    deadline = time.time() + 5.0
    while _compile_threads() and time.time() < deadline:
        time.sleep(0.01)
    assert not _compile_threads(), "executor threads leaked after GC"


# ---------------------------------------------------------------------------
# The gate: a compile-and-serve trace of the port passes check_trace
# ---------------------------------------------------------------------------

def _write_trace(trace_dir):
    trace_dir.mkdir()
    n = telemetry.export_jsonl(trace_dir / "trace.jsonl")
    (trace_dir / "metrics.prom").write_text(telemetry.prometheus())
    return n


def test_compile_and_serve_trace_passes_the_gate(tmp_path):
    telemetry.enable()
    jnets = [_jnet(8), _jnet(9)]
    store = netgen.ArtifactStore(tmp_path / "store")
    with _session(store=store, capacity=4) as session:
        server = netgen.NetServer(session=session, target="cuda[planes=true]",
                                  slot_capacity=8, warmup=False)
        for i, jnet in enumerate(jnets):
            server.register(f"v{i}", quantize.from_numpy(jnet.weights))
        x = _x(3, 11)
        out = server.predict_many({"v0": x, "v1": x[:4]})
        single = server.predict("v1", x)
    np.testing.assert_array_equal(out["v0"], _ref(jnets[0], x))
    np.testing.assert_array_equal(single, _ref(jnets[1], x))
    assert _write_trace(tmp_path / "trace") > 0
    spans = [json.loads(line) for line in (tmp_path / "trace" / "trace.jsonl").read_text()
             .splitlines()]
    by_id = {s["span_id"]: s for s in spans}
    stacked = [s for s in spans if s["name"] == "netgen.kernel"
               and by_id[s["parent_id"]]["attrs"]["path"] == "stacked"]
    # round 0 stacks both versions on the megakernel; v0's second round
    # is its own, on the per-layer chain
    assert [(s["attrs"]["form"], s["attrs"]["launches"]) for s in stacked] == \
        [("fusednet", 1), ("planes", 2)]
    samples = parse_prometheus((tmp_path / "trace" / "metrics.prom").read_text())
    assert check_spans(spans) == []
    assert check_metrics(samples) == []
    assert check_launches(spans, samples) == []
    assert check_trace_dir(tmp_path / "trace") == []
    # warm: a second process's view of the same store never compiles
    telemetry.reset()
    with _session(store=store, capacity=4) as session:
        server = netgen.NetServer(session=session, target="cuda[planes=true]",
                                  slot_capacity=8, warmup=False)
        server.register("v0", quantize.from_numpy(jnets[0].weights))
        server.predict_many({"v0": x})
    _write_trace(tmp_path / "warm")
    names = {json.loads(line)["name"] for line in
             (tmp_path / "warm" / "trace.jsonl").read_text().splitlines()}
    assert "netgen.compile" not in names and "netgen.store.load" in names
    assert check_trace_dir(tmp_path / "warm") == []


def test_report_and_prometheus_shape():
    telemetry.enable()
    telemetry.counter("demo_total", kind="x").inc(2)
    with telemetry.span("demo.span"):
        telemetry.histogram("demo_seconds").observe(0.25)
    text = telemetry.report()
    assert 'demo_total{kind="x"}: 2' in text and "span      demo.span: n=1" in text
    prom = telemetry.prometheus()
    assert "# TYPE demo_seconds summary" in prom
    assert 'demo_seconds{quantile="0.5"} 0.25' in prom and "demo_seconds_count 1" in prom
    with telemetry.timed("demo_block_seconds") as t:
        pass
    assert telemetry.histogram("demo_block_seconds").count == 1 and t.elapsed >= 0
