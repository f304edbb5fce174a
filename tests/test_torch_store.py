"""The port's compile tiers against the JAX package's, on the CPU.

The in-memory `CompileCache` (compiles outside its lock, concurrent
requests for one key coalesced), the persistent `ArtifactStore` (the
reference's layout field for field, warm second sessions and processes,
corrupt entries, gc bounds), the content address with its compiler
source fingerprint, the store linter and its CLI, and the old entry
points (`compile_net`, `specialize`, `emit_verilog`, `core.netgen`).
"""
import json
import os
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import netgen as jnetgen
from repro.core import netgen as jcore_netgen
from repro.core import quantize as jquantize
from repro_torch import netgen
from repro_torch.core import netgen as core_netgen
from repro_torch.core import quantize
from repro_torch.netgen import analysis, session as session_mod, targets

from _netgen_helpers import images, random_net

ROOT = Path(__file__).resolve().parent.parent
SIZES = (12, 9, 4)


def _jnet(seed: int, sizes=SIZES):
    return random_net(seed, sizes, lo=-5, hi=5)


def _net(seed: int, sizes=SIZES):
    return quantize.from_numpy(_jnet(seed, sizes).weights)


def _x(seed: int, b: int, n_in: int = SIZES[0]) -> np.ndarray:
    return images(seed, b, n_in, salt=55)


def _ref(jnet, x):
    return np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x)))


def _session(**kw):
    return netgen.Session(device="cpu", **kw)


def _bounded(fn, timeout: float):
    """Run fn on a thread and join it with a timeout: a call that
    blocks fails the test instead of hanging it."""
    out: dict = {}
    t = threading.Thread(target=lambda: out.update(value=fn()), daemon=True)
    t.start()
    t.join(timeout)
    return out


# ---------------------------------------------------------------------------
# C4: a cold compile blocks no other key
# ---------------------------------------------------------------------------

def _slow_target(monkeypatch, name: str):
    """A fake target whose compile blocks until `release`; registered for
    the length of one test, since the registry is process-wide."""
    started, release = threading.Event(), threading.Event()

    def slow_compile(circuit, **opts):
        started.set()
        assert release.wait(20.0), "test never released the slow compile"
        return lambda x: torch.zeros((np.asarray(x).shape[0],), dtype=torch.int32)

    monkeypatch.setitem(targets._REGISTRY, name, netgen.Target(
        name=name, kind="callable", description="test-only gated-slow compile",
        compile=slow_compile))
    return started, release


@pytest.mark.parametrize("tier", ["cache", "session"])
def test_cache_compile_does_not_block_unrelated_keys(tier, monkeypatch):
    """While key A sits in a slow compile, a hit on key B and a fresh
    compile of key C proceed; the parent held the session's lock across
    every compile. Bounded joins: a regression fails, it does not hang."""
    started, release = _slow_target(monkeypatch, f"slowfake_hol_{tier}")
    owner = (netgen.CompileCache(device="cpu") if tier == "cache"
             else _session(capacity=8))

    def get(net, backend="torch"):
        if tier == "cache":
            return owner.get_or_compile(net, backend=backend)
        return owner.compile(net, target=backend)

    net_a, net_b, net_c = _net(80), _net(81), _net(82)
    warm_b = get(net_b)                      # resident before the stall
    out: dict = {}
    slow = threading.Thread(
        target=lambda: out.update(a=get(net_a, f"slowfake_hol_{tier}")), daemon=True)
    slow.start()
    try:
        assert started.wait(10.0)
        assert _bounded(lambda: get(net_b), 5.0).get("value") is warm_b, \
            "hit on unrelated key blocked behind an in-flight compile"
        assert "value" in _bounded(lambda: get(net_c), 30.0), \
            "compile of unrelated key blocked behind an in-flight compile"
        # a second request for A joins the in-flight compile
        joiner = threading.Thread(
            target=lambda: out.update(a2=get(net_a, f"slowfake_hol_{tier}")), daemon=True)
        joiner.start()
    finally:
        release.set()
        slow.join(10.0)
    joiner.join(10.0)
    assert not slow.is_alive() and not joiner.is_alive()
    assert out["a"] is out["a2"] is get(net_a, f"slowfake_hol_{tier}")
    st = owner.stats()
    assert st.misses == st.compiles == 3     # b, a, c: one compile each
    assert st.hits == 3                      # the gated hit, the joiner, the re-get


def test_failed_compile_is_counted_and_raised():
    """A compile that raises is counted as a failure (misses == compiles
    + store_hits + failures), raised, and leaves nothing in the table."""
    w1 = np.ones((4, 2), np.int32)
    w1[:, 0] = 2 ** 30
    net = quantize.QuantizedNet(weights=[w1, np.eye(2, dtype=np.int32)])
    cache = netgen.CompileCache(device="cpu")
    for _ in range(2):
        with pytest.raises(netgen.VerificationError):
            cache.get_or_compile(net)
    st = cache.stats()
    assert (st.misses, st.compiles, st.failures) == (2, 0, 2)
    assert len(cache) == 0


# ---------------------------------------------------------------------------
# C5: the content address folds in the compiler's sources
# ---------------------------------------------------------------------------

def test_artifact_key_includes_compiler_sources():
    """The store key folds in a fingerprint of the port's netgen sources,
    so a compiler edit can never warm-start stale circuits."""
    net = _net(42)
    spec = netgen.PipelineSpec.named("default")
    k1 = session_mod.artifact_key(net.digest(), spec, "torch")
    old = session_mod._SOURCE_FINGERPRINT
    try:
        session_mod._SOURCE_FINGERPRINT = "deadbeef"   # simulate a code change
        k2 = session_mod.artifact_key(net.digest(), spec, "torch")
    finally:
        session_mod._SOURCE_FINGERPRINT = old
    assert k1 != k2
    assert session_mod._source_fingerprint() == old


def test_source_fingerprint_reads_the_ports_own_sources():
    """sha256 over `repro_torch/netgen/**/*.py` plus the port's
    `core/quantize.py`: the port's keys differ from the reference's for
    the same net, pipeline and target, which is correct."""
    import hashlib
    pkg = ROOT / "src" / "repro_torch" / "netgen"
    h = hashlib.sha256()
    for f in sorted(pkg.rglob("*.py")) + [pkg.parent / "core" / "quantize.py"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    assert session_mod._source_fingerprint() == h.hexdigest()
    jnet = _jnet(43)
    art = _session().compile(_net(43), target="verilog")
    jart = jnetgen.Session().compile(jnet, target="verilog")
    assert (art.digest, art.pipeline, art.target) == (jart.digest, jart.pipeline, jart.target)
    assert art.key != jart.key


# ---------------------------------------------------------------------------
# The store: the reference's layout, field for field
# ---------------------------------------------------------------------------

def _entries(root: Path) -> dict:
    out = {}
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        meta = json.loads((d / "meta.json").read_text())
        with np.load(d / "circuit.npz") as z:
            arrays = {k: z[k] for k in z.files}
        txt = (d / "artifact.txt").read_bytes() if (d / "artifact.txt").exists() else None
        out[meta["target"]] = (meta, arrays, txt, sorted(os.listdir(d)))
    return out


@pytest.mark.parametrize("pipeline", ["default", "zeros,prune,addends", "hw"])
def test_store_entries_equal_the_reference(tmp_path, pipeline):
    jnet = _jnet(44)
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    session = _session(store=mine)
    jsession = jnetgen.Session(store=ref)
    for target in ("verilog", "cost"):
        session.compile(_net(44), target=target, pipeline=pipeline)
        jsession.compile(jnet, target=target, pipeline=pipeline)
    got, want = _entries(mine), _entries(ref)
    assert sorted(got) == sorted(want) == ["cost", "verilog"]
    for target in got:
        (meta, arrays, txt, files), (jmeta, jarrays, jtxt, jfiles) = got[target], want[target]
        assert files == jfiles
        skip = ("created_unix", "timings")
        assert {k: v for k, v in meta.items() if k not in skip} == \
            {k: v for k, v in jmeta.items() if k not in skip}
        assert set(meta) == set(jmeta)
        assert sorted(arrays) == sorted(jarrays)
        for k in arrays:
            np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)
            assert arrays[k].dtype == jarrays[k].dtype, k
        assert txt == jtxt


def test_lint_flags_only_the_key_on_a_store_the_reference_wrote(tmp_path):
    ref = tmp_path / "ref"
    jsession = jnetgen.Session(store=ref)
    jsession.compile(_jnet(45), target="verilog", pipeline="hw")
    jsession.compile(_jnet(45), target="cost", pipeline="zeros,prune,addends")
    jsession.compile(_jnet(46), target="pallas[planes=true]")
    jsession.compile(_jnet(46), target="jnp")
    failures = analysis.lint_store(ref)
    assert len(failures) == 4
    for key, diags in failures.items():
        assert [d.check for d in diags] == ["store.key"], (key, diags)
    # the reference's own linter passes its store
    from repro.netgen import analysis as janalysis
    assert janalysis.lint_store(ref) == {}


def test_artifact_store_warm_second_session(tmp_path):
    """A second Session over the same directory rebuilds predictors from
    the store on its own device: zero compiles, equal answers."""
    store_dir = tmp_path / "store"
    jnet = _jnet(8)
    x = _x(8, 12)
    first = _session(store=netgen.ArtifactStore(store_dir))
    cold = first.compile(_net(8), target="cuda[planes=true]")
    assert first.stats().compiles == 1 and cold.source == "compile"
    warm_session = _session(store=netgen.ArtifactStore(store_dir))
    warm = warm_session.compile(_net(8), target="cuda[planes=true]")
    st = warm_session.stats()
    assert (st.compiles, st.store_hits) == (0, 1)
    assert warm_session.store_stats().loads == 1
    assert warm.source == "store" and warm.key == cold.key
    assert "load_s" in warm.timings and warm.plan_form == cold.plan_form == "planes"
    assert [s.row() for s in warm.pass_stats] == [s.row() for s in cold.pass_stats]
    assert warm.cost == cold.cost and warm.analysis == cold.analysis
    assert (warm.artifact.datapath, warm.artifact.launches_per_call) == ("planes", 2)
    np.testing.assert_array_equal(warm(x).numpy(), cold(x).numpy())
    np.testing.assert_array_equal(warm(x).numpy(), _ref(jnet, x))


def test_artifact_store_text_and_report_round_trip(tmp_path):
    store_dir = tmp_path / "store"
    net = _net(9)
    a, b = _session(store=store_dir), _session(store=store_dir)
    v_cold = a.compile(net, target="verilog", pipeline="hw")
    v_warm = b.compile(net, target="verilog", pipeline="hw")
    assert v_warm.source == "store" and v_warm.artifact == v_cold.artifact
    c_cold = a.compile(net, target="cost", pipeline="hw")
    c_warm = b.compile(net, target="cost", pipeline="hw")
    assert c_warm.artifact.as_dict() == c_cold.artifact.as_dict()
    assert b.stats().compiles == 0


def test_artifact_store_cross_process_reuse(tmp_path):
    """Compile in a SUBPROCESS (the port alone, on the CPU), then load
    warm in this process: equal answers and zero compiles."""
    store_dir = tmp_path / "store"
    x = _x(10, 16)
    script = f"""
import json, sys
import numpy as np
sys.modules['jax'] = None
sys.modules['repro'] = None
from repro_torch import netgen
from repro_torch.core import quantize

rng = np.random.default_rng(10)         # random_net(10, (12, 9, 4), lo=-5, hi=5)
net = quantize.from_numpy([rng.integers(-5, 6, size=s).astype(np.int32)
                           for s in ((12, 9), (9, 4))])
x = np.random.default_rng(10 + 55).integers(0, 256, size=(16, 12)).astype(np.uint8)
session = netgen.Session(device="cpu", store={str(store_dir)!r})
art = session.compile(net, target="cuda[fusednet=true]")
print(json.dumps({{"key": art.key, "compiles": session.stats().compiles,
                  "preds": art(x).tolist()}}))
"""
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    child = json.loads(out.stdout.strip().splitlines()[-1])
    assert child["compiles"] == 1
    session = _session(store=netgen.ArtifactStore(store_dir))
    art = session.compile(_net(10), target="cuda[fusednet=true]")
    st = session.stats()
    assert (st.compiles, st.store_hits, st.compile_seconds) == (0, 1, 0.0)
    assert art.key == child["key"]
    np.testing.assert_array_equal(art(x).numpy(), np.asarray(child["preds"]))
    np.testing.assert_array_equal(art(x).numpy(), _ref(_jnet(10), x))


def test_artifact_store_layout_and_idempotent_put(tmp_path):
    store = netgen.ArtifactStore(tmp_path / "store")
    art = netgen.compile_artifact(_net(11), target="verilog")
    store.put(art)
    assert art.key in store and len(store) == 1
    store.put(art)                           # second put: no-op
    assert store.stats.saves == 1
    meta = json.loads((tmp_path / "store" / art.key / "meta.json").read_text())
    assert meta["target"] == "verilog" and meta["pipeline"] == "zeros,prune"
    assert store.get("0" * 64, device="cpu") is None
    assert store.stats.misses == 1


def test_artifact_store_recovers_from_corrupt_entry(tmp_path):
    """Bit-rot degrades to a recompile, not a hard failure: an unreadable
    payload is evicted and re-missed, and the recompile re-creates it."""
    store_dir = tmp_path / "store"
    jnet = _jnet(13)
    x = _x(13, 8)
    cold = _session(store=store_dir).compile(_net(13), target="cuda")
    (store_dir / cold.key / "circuit.npz").write_bytes(b"not a zipfile")
    session = _session(store=netgen.ArtifactStore(store_dir))
    art = session.compile(_net(13), target="cuda")
    st = session.stats()
    assert (st.compiles, st.store_hits) == (1, 0)
    assert session.store.stats.corrupt == 1
    np.testing.assert_array_equal(art(x).numpy(), _ref(jnet, x))
    assert _session(store=store_dir).compile(_net(13), target="cuda").source == "store"


def test_artifact_store_gc_count_and_byte_bounds(tmp_path):
    """put() runs gc when a bound is set; get() refreshes recency, so a
    reused entry survives a never-reused older one."""
    store = netgen.ArtifactStore(tmp_path / "store", max_entries=2)
    arts = [netgen.compile_artifact(_net(60 + i), target="verilog") for i in range(3)]
    now = time.time()
    for i, art in enumerate(arts[:2]):
        store.put(art)
        os.utime(tmp_path / "store" / art.key / "meta.json",
                 (now - 100 + i, now - 100 + i))
    assert store.get(arts[0].key, device="cpu") is not None   # touch: 0 newer than 1
    store.put(arts[2])                       # bound hit: evicts 1
    assert store.stats.gc_evictions == 1
    assert sorted(store.keys()) == sorted([arts[0].key, arts[2].key])
    assert store.get(arts[1].key, device="cpu") is None
    free = netgen.ArtifactStore(tmp_path / "free")
    for art in arts:
        free.put(art)
    assert free.gc() == [] and len(free) == 3
    tiny = netgen.ArtifactStore(tmp_path / "tiny", max_bytes=1)
    tiny.put(arts[0])
    assert tiny.gc() == [] and len(tiny) == 0 and tiny.stats.gc_evictions == 1
    for kw in ({"max_entries": 0}, {"max_bytes": 0}):
        with pytest.raises(ValueError, match=next(iter(kw))):
            netgen.ArtifactStore(tmp_path / "bad", **kw)


def test_uncached_session_over_store(tmp_path):
    """capacity=0 keeps nothing in memory but still reads and writes the
    store, counting through the same counters."""
    jnet = _jnet(14)
    x = _x(14, 6)
    a = _session(store=tmp_path / "s", capacity=0)
    first = a.compile(_net(14), target="fused")
    second = a.compile(_net(14), target="fused")
    st = a.stats()
    assert (st.misses, st.compiles, st.store_hits, st.hits) == (2, 1, 1, 0)
    assert first.source == "compile" and second.source == "store"
    np.testing.assert_array_equal(second(x).numpy(), _ref(jnet, x))
    with pytest.raises(ValueError, match="in-memory tier"):
        netgen.NetServer(session=a)


def test_netserver_over_session(tmp_path):
    """NetServer(session=...) serves through the session's store: a
    second server in a fresh session warm-starts every version."""
    store_dir = tmp_path / "store"
    jnets = {f"v{i}": _jnet(20 + i) for i in range(2)}
    x = _x(20, 8)
    outs = []
    for _ in range(2):
        s = _session(store=store_dir)
        server = netgen.NetServer(session=s, target="cuda[planes=true]", slot_capacity=8)
        assert server.cache is s.cache and server.device == torch.device("cpu")
        for name, jnet in jnets.items():
            server.register(name, quantize.from_numpy(jnet.weights))
        outs.append((s.stats(), server.predict_many({"v0": x, "v1": x})))
    (cold, out), (warm, out2) = outs
    assert (cold.compiles, warm.compiles, warm.store_hits) == (2, 0, 2)
    for name, jnet in jnets.items():
        np.testing.assert_array_equal(out[name], _ref(jnet, x))
        np.testing.assert_array_equal(out2[name], out[name])
    with pytest.raises(ValueError, match="not both"):
        netgen.NetServer(session=s, cache=netgen.CompileCache(device="cpu"))


def test_compile_cache_keys_lru_and_passes(tmp_path):
    cache = netgen.CompileCache(capacity=2, device="cpu")
    nets = [_net(70 + i) for i in range(3)]
    k0 = cache.key_for(nets[0], backend="cuda[planes=true]")
    assert k0 == cache.key_for(nets[0], backend="cuda", planes=True)
    assert k0.passes == "zeros,prune" and k0.backend == "cuda"
    a = cache.get_or_compile(nets[0], backend="cuda[planes=true]")
    assert k0 in cache and cache.compile_seconds(k0) > 0
    for n in nets[1:]:
        cache.get_or_compile(n, backend="cuda[planes=true]")
    assert k0 not in cache and len(cache) == 2 and cache.stats().evictions == 1
    assert cache.compile_seconds(k0) is None
    assert cache.get_or_compile(nets[0], backend="cuda[planes=true]") is not a
    p = netgen.serve._pass_fingerprint
    import functools
    assert p(functools.partial(netgen.share_common_addends, max_new_nodes=2)) == \
        "cse[budget=2]" == jnetgen.serve._pass_fingerprint(
            functools.partial(jnetgen.share_common_addends, max_new_nodes=2))
    with pytest.raises(ValueError):
        netgen.CompileCache(capacity=0, device="cpu")


def test_stack_layered_weights_equals_the_reference():
    jnets = [_jnet(90 + i) for i in range(3)]
    circuits = [netgen.PipelineSpec.coerce(None).run(netgen.lower(_net(90 + i)))[0]
                for i in range(3)]
    jcircuits = [jnetgen.PipelineSpec.coerce(None).run(jnetgen.lower(j))[0] for j in jnets]
    thr, ws = netgen.stack_layered_weights(circuits)
    jthr, jws = jnetgen.stack_layered_weights(jcircuits)
    assert thr == jthr and len(ws) == len(jws)
    for w, jw in zip(ws, jws):
        np.testing.assert_array_equal(w, jw)
    with pytest.raises(ValueError):
        netgen.stack_layered_weights([])


# ---------------------------------------------------------------------------
# The linter and its CLI
# ---------------------------------------------------------------------------

def _cli(*args, block=False):
    code = ("import sys, runpy\n"
            + ("sys.modules['jax'] = None\nsys.modules['repro'] = None\n" if block else "")
            + f"sys.argv = ['analysis', *{list(args)!r}]\n"
            "runpy.run_module('repro_torch.netgen.analysis', run_name='__main__')\n")
    return subprocess.run(
        [sys.executable, "-W", "ignore::RuntimeWarning", "-c", code], capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_lint_store_and_cli_exit_codes(tmp_path):
    store_dir = tmp_path / "store"
    session = _session(store=store_dir)
    keys = [session.compile(_net(95), target=t).key
            for t in ("cuda[planes=true]", "verilog", "cost")]
    assert analysis.lint_store(store_dir) == {}
    ok = _cli(str(store_dir), block=True)
    assert ok.returncode == 0, ok.stderr
    assert "linted 3 artifact(s): 3 ok, 0 failed" in ok.stdout
    # a stale key, a cost that does not recompute, an unreadable circuit
    stale = store_dir / ("f" * 64)
    os.rename(store_dir / keys[0], stale)
    meta = json.loads((store_dir / keys[1] / "meta.json").read_text())
    meta["cost"]["compare_cells"] += 1
    (store_dir / keys[1] / "meta.json").write_text(json.dumps(meta))
    (store_dir / keys[2] / "circuit.npz").write_bytes(b"rot")
    failures = analysis.lint_store(store_dir)
    assert sorted(d.check for ds in failures.values() for d in ds) == \
        ["store.circuit", "store.cost", "store.key"]
    bad = _cli(str(store_dir), "-q")
    assert bad.returncode == 1 and bad.stdout.count("FAIL") == 3
    missing = _cli(str(tmp_path / "nowhere"))
    assert missing.returncode == 2 and "no artifact store" in missing.stderr
    with pytest.raises(FileNotFoundError):
        analysis.lint_store(tmp_path / "nowhere")


# ---------------------------------------------------------------------------
# The old entry points
# ---------------------------------------------------------------------------

def _paper_net(seed=3):
    rng = np.random.default_rng(seed)
    return jquantize.QuantizedNet(
        w1=rng.integers(-9, 10, size=(9, 3)).astype(np.int32),
        w2=rng.integers(-9, 10, size=(3, 2)).astype(np.int32))


@pytest.mark.parametrize("addend", [True, False])
def test_core_emit_verilog_byte_equal(addend):
    jnet = _paper_net()
    net = quantize.from_numpy(jnet.weights)
    got = core_netgen.emit_verilog(net, addend=addend, module_name="m")
    assert got == jcore_netgen.emit_verilog(jnet, addend=addend, module_name="m")
    assert got == netgen.emit_verilog(net, addend=addend, module_name="m")


@pytest.mark.parametrize("sizes", [(12, 9, 4), (16, 10, 6, 3)])
def test_core_prune_and_stats_equal(sizes):
    ws = [w.copy() for w in _jnet(96, sizes).weights]
    ws[0][:, :3] = 0                         # dead hidden units
    ws[-1][1, :] = 0
    jnet = jquantize.QuantizedNet(weights=ws)
    pruned, info = core_netgen.prune(quantize.from_numpy(ws))
    jpruned, jinfo = jcore_netgen.prune(jnet)
    assert info.__dict__ == jinfo.__dict__ and info.hidden_removed == jinfo.hidden_removed
    for w, jw in zip(pruned.weights, jpruned.weights):
        np.testing.assert_array_equal(w, jw)
    assert core_netgen.stats(quantize.from_numpy(ws)).as_dict() == \
        jcore_netgen.stats(jnet).as_dict()


def test_specialize_and_compile_net_through_the_default_session(monkeypatch):
    jnet = _jnet(97)
    x = _x(97, 9)
    monkeypatch.setattr(netgen, "_DEFAULT_SESSION", _session(capacity=4))
    for backend in ("torch", "cuda"):
        fn = core_netgen.specialize(quantize.from_numpy(jnet.weights), backend=backend)
        np.testing.assert_array_equal(fn(x).numpy(), _ref(jnet, x))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        compiled = netgen.compile_net(quantize.from_numpy(jnet.weights))
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert isinstance(compiled, netgen.CompiledNet) and compiled.backend == "torch"
    np.testing.assert_array_equal(compiled(x).numpy(), _ref(jnet, x))

    def budgeted(c):
        return netgen.share_common_addends(c, max_new_nodes=2)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        via_closure = netgen.compile_net(
            quantize.from_numpy(jnet.weights), backend="verilog",
            passes=(netgen.delete_zero_terms, budgeted))
        repeated = netgen.compile_net(
            quantize.from_numpy(jnet.weights), backend="cuda",
            passes=(netgen.delete_zero_terms, netgen.prune_dead_units,
                    netgen.delete_zero_terms))
    assert "endmodule" in via_closure.artifact
    assert [s.name for s in via_closure.pass_stats][-1] == "budgeted"
    np.testing.assert_array_equal(repeated(x).numpy(), _ref(jnet, x))


# ---------------------------------------------------------------------------
# No quiet CPU
# ---------------------------------------------------------------------------

def test_entry_points_want_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(netgen, "_DEFAULT_SESSION", None)
    with pytest.raises(RuntimeError):
        netgen.Session(store=tmp_path / "s")
    with pytest.raises(RuntimeError):
        netgen.default_session()
    with pytest.raises(RuntimeError):
        netgen.CompileCache()
    with pytest.raises(RuntimeError):
        netgen.cached_compile_net(_net(1))
    with pytest.raises(RuntimeError):
        netgen.backends.compile_circuit(netgen.lower(_net(1)), "cuda")
    with pytest.raises(RuntimeError):
        netgen.compile_artifact(_net(1), target="cuda")
    store = netgen.ArtifactStore(tmp_path / "s")
    key = _session(store=store).compile(_net(1), target="cuda").key
    with pytest.raises(RuntimeError):
        store.get(key)
    assert key in store                      # the raise left the entry alone
    assert store.get(key, device="cpu").source == "store"
    # host-only targets need no device, in a compile or a store read
    assert netgen.compile_artifact(_net(1), target="verilog").kind == "text"
    for target, kind in (("verilog", "text"), ("cost", "report")):
        stored = _session(store=store).compile(_net(1), target=target)
        loaded = store.get(stored.key)
        assert (loaded.source, loaded.kind) == ("store", kind)
        if kind == "text":
            assert loaded.artifact == stored.artifact
        else:
            assert loaded.artifact.as_dict() == stored.artifact.as_dict()
