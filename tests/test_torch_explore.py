"""The port's design-space explorer against the JAX package's, on the CPU.

`repro_torch.netgen.explore` (`Session.explore`): with the deterministic
`cells` objective, the same seed, space shape and budget, the port's
report has the JAX report's winner, per-candidate cells and acceptance
trace over (net, pipeline, form) — the tile axis is Hopper's own, of the
same length; the `cuda-explored` record resolves with zero
measurements, in this process and a second session; the telemetry
identities `benchmarks/check_trace.py` gates hold; the serving layer's
stacked dispatch prefers the explored record. Integer answers are
compared exactly; cells are integers.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

from repro import netgen as jnetgen
from repro.core import quantize as jquantize
from repro_torch import netgen
from repro_torch.core import quantize
from repro_torch.netgen import telemetry
from repro_torch.netgen.backends import cuda as cuda_backend
from repro_torch.netgen.explore import Candidate, SearchSpace

from _netgen_helpers import images, random_net

ROOT = Path(__file__).resolve().parent.parent
SIZES = (20, 16, 4)
FAST = dict(budget=6, seed=0, batch=16, reps=1)


def _net(seed: int):
    return random_net(seed, SIZES, lo=-5, hi=5)


def _want(net, x) -> np.ndarray:
    return np.asarray(jquantize.predict_quantized(net)(jnp.asarray(x)))


def _session(tmp_path, name="a"):
    return netgen.Session(device="cpu", store=tmp_path / f"art-{name}",
                          tune_store=tmp_path / f"tune-{name}")


def _walk(report) -> list:
    """The acceptance trace over (net, pipeline, form)."""
    return [(t["step"], t["candidate"]["net"], t["candidate"]["pipeline"],
             t["candidate"]["form"], t["value"], t["pruned"] is not None,
             t["accepted"], t["best"]) for t in report.trace]


def _cells(report) -> list:
    return [((c["net"], c["pipeline"], c["form"]), v) for c, v in report.evaluations]


@pytest.mark.parametrize("strategy", ["random", "anneal"])
def test_cells_exploration_walks_the_reference_search(tmp_path, strategy):
    net = _net(11)
    nets = {"a": net, "b": random_net(12, (20, 12, 8, 4), lo=-5, hi=5)}
    kw = dict(objective="cells", strategy=strategy, budget=10, seed=3, batch=16, reps=1)
    want = jnetgen.Session(store=tmp_path / "jart", tune_store=tmp_path / "jtune").explore(
        nets=nets, interpret=True, **kw)
    got = _session(tmp_path).explore(
        nets={k: quantize.from_numpy(v.weights) for k, v in nets.items()}, **kw)
    assert len(SearchSpace(nets=("a", "b")).candidates()) \
        == len(jnetgen.explore.SearchSpace(nets=("a", "b")).candidates())
    assert (got.best.net, got.best.pipeline, got.best.form) \
        == (want.best.net, want.best.pipeline, want.best.form)
    assert got.best_value == want.best_value
    assert _cells(got) == _cells(want)
    assert _walk(got) == _walk(want)
    assert len(got.pruned) == len(want.pruned) and got.candidates == want.candidates
    assert got.source == "search" and got.device_kind == "cpu"


def test_search_space_and_candidates_speak_cuda():
    space = SearchSpace(pipelines=("default",), forms=("dense", "planes"),
                        tiles=({"bm": 32, "bn": 32},))
    cands = space.candidates()
    assert [c.pipeline for c in cands] == ["zeros,prune"] * 2
    assert [c.target() for c in cands] == ["cuda[bm=32,bn=32]",
                                           "cuda[bm=32,bn=32,planes=true]"]
    assert SearchSpace().tiles == cuda_backend._TUNE_BLOCKS
    assert Candidate.from_dict({**cands[1].as_dict(), "bkw": 8}) == cands[1]   # a JAX record
    with pytest.raises(ValueError):
        SearchSpace(forms=("bogus",))


def test_latency_exploration_publishes_a_record_that_resolves_unmeasured(tmp_path):
    net = _net(14)
    x = images(14, 10, SIZES[0])
    session = _session(tmp_path)
    rep = session.explore(net, objective="latency", strategy="anneal", **FAST)
    assert rep.evaluations and all(v > 0 for _, v in rep.evaluations)
    spec, target = rep.best_config()
    assert target.startswith("cuda[") and "bkw" not in target
    art = session.compile(net, target=target, pipeline=spec.spec_string())
    np.testing.assert_array_equal(art(x).numpy(), _want(net, x))
    assert Candidate.from_dict(json.loads(json.dumps(rep.as_dict()))["best"]) == rep.best
    assert "explore[" in rep.describe()

    hits = telemetry.get_registry().counter(
        "netgen_explored_resolved_total", outcome="hit")
    for s in (session, _session(tmp_path)):        # this session, then a second one
        before, measured = hits.value, s.tune_stats().measurements
        explored = s.compile(net, target="cuda[explored=true]", pipeline=rep.best.pipeline)
        assert hits.value == before + 1
        assert s.tune_stats().measurements == measured
        assert explored.artifact.datapath == rep.best.form
        assert explored.artifact.blocks == {"bm": rep.best.bm, "bn": rep.best.bn}
        np.testing.assert_array_equal(explored(x).numpy(), _want(net, x))
    assert _session(tmp_path).tune_stats().measurements == 0


def test_explored_without_a_record_is_inert(tmp_path):
    net = _net(15)
    misses = telemetry.get_registry().counter(
        "netgen_explored_resolved_total", outcome="miss")
    before = misses.value
    art = _session(tmp_path).compile(net, target="cuda[explored=true]")
    assert misses.value == before + 1 and art.artifact.datapath == "dense"


def test_warm_second_session_replays_with_zero_measurements_and_compiles(tmp_path):
    net = _net(16)
    first = _session(tmp_path).explore(net, objective="latency", strategy="random", **FAST)
    second_session = _session(tmp_path)
    second = second_session.explore(net, objective="latency", strategy="random", **FAST)
    assert second.source == "store"
    assert second.best == first.best and second.trace == first.trace
    assert second_session.tune_stats().measurements == 0
    assert second_session.stats().compiles == 0


def test_explorer_counters_satisfy_the_trace_gate(tmp_path):
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        from check_trace import check_explore, parse_prometheus
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    rep = _session(tmp_path).explore(
        _net(17), objective="latency", strategy="random",
        space=SearchSpace(pipelines=("default", "zeros,prune,addends,cse[bucketed=true]")),
        **FAST)
    assert any("no ExecutionPlan" in r for _, r in rep.pruned)     # CSE'd: pruned unmeasured
    samples = parse_prometheus(telemetry.prometheus())
    assert check_explore(samples) == []
    assert any(name == "netgen_explore_candidates_total" and v > 0
               for name, _, v in samples)


def test_serving_prefers_the_explored_record(tmp_path):
    session = _session(tmp_path)
    nets = {"v0": _net(18), "v1": _net(19)}
    session.explore(nets["v0"], objective="latency", strategy="random",
                    space=SearchSpace(pipelines=("default",), forms=("packed",)), **FAST)
    hits = telemetry.get_registry().counter(
        "netgen_explored_resolved_total", outcome="hit")
    before = hits.value
    server = netgen.NetServer(session=session, target="cuda", slot_capacity=16)
    for name, net in nets.items():
        server.register(name, net)
    reqs = {name: images(30 + i, 16, SIZES[0]) for i, name in enumerate(nets)}
    out = server.predict_many(reqs)
    for name, x in reqs.items():
        np.testing.assert_array_equal(out[name], _want(nets[name], x))
    assert server.dispatch_counts["stacked"] >= 1
    assert hits.value == before + 1             # the stacked build took the record
    (fn,) = [f for f in server._multi.values() if f is not None]
    assert fn.datapath == "packed"
    off = netgen.NetServer(session=session, target="cuda", slot_capacity=16,
                           prefer_explored=False)
    assert not off.prefer_explored
