"""Parity of the port's hardware output with the JAX package's: the
`verilog` and `cost` targets, adder sharing (`cse`) and the `hw`
pipeline, the interpreter, the circuit codec and the range-proof
analysis (`repro_torch.netgen.analysis`).

Everything here is numpy and text, so every comparison is exact: the
port on `device="cpu"` against the JAX package on the same nets. Circuits
are compared node for node (ids, term order, insertion points), Verilog
byte for byte, the golden files of the paper's 3x3 net included.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

from repro import netgen as jnetgen
from repro.core import quantize as jquantize
from repro.netgen import analysis as janalysis
from repro.netgen.backends.verilog import emit_verilog as jemit_verilog
from repro.netgen.plan import lower_circuit as jlower_circuit
from repro_torch import netgen
from repro_torch.core import quantize
from repro_torch.netgen import analysis
from repro_torch.netgen.backends.verilog import emit_verilog
from repro_torch.netgen.pipeline import PassDef
from repro_torch.netgen.plan import lower_circuit

from _netgen_helpers import images, random_net

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SIZES = [(40, 6), (45, 21, 7), (33, 40, 12, 5), (64, 32, 10)]
SMALL = ["golden"] + SIZES
PIPELINES = ["default", "zeros,prune,addends", "hw"]


def _golden_net():
    rng = np.random.default_rng(1)
    return jquantize.QuantizedNet(
        w1=rng.integers(-9, 10, size=(3, 3)).astype(np.int32),
        w2=rng.integers(-9, 10, size=(3, 3)).astype(np.int32))


def _sparse_net(seed, sizes):
    """A net with zero terms and dead hidden units for the passes."""
    net = random_net(seed, sizes, lo=-3, hi=3)
    ws = [w.copy() for w in net.weights]
    ws[0][:, ::3] = 0
    if len(ws) > 1:
        ws[1][1::4, :] = 0
    return jquantize.QuantizedNet(weights=ws)


def _small_net(sizes):
    return _golden_net() if sizes == "golden" else _sparse_net(len(sizes), sizes)


def _port(net):
    return quantize.from_numpy(net.weights, net.input_threshold)


def _nodes(c):
    """A circuit as plain tuples: (kind, fields) per node, in order."""
    return ((c.n_inputs, c.input_threshold, c.output),
            [(type(n).__name__, dataclasses.astuple(n)) for n in c.nodes])


def _rows(stats):
    return [(s.name, s.row(), s.before.as_dict(), s.after.as_dict(),
             s.terms_deleted, s.adds_saved) for s in stats]


@functools.lru_cache(maxsize=None)
def _compiled(sizes, pipeline):
    """(port circuit, port stats, JAX circuit, JAX stats) of one small
    net under one pipeline, verified at every pass boundary."""
    jnet = _small_net(sizes)
    jc, jstats = jnetgen.PipelineSpec.coerce(pipeline).run(
        jnetgen.lower(jnet), verify=True)
    c, stats = netgen.PipelineSpec.coerce(pipeline).run(
        netgen.lower(_port(jnet)), verify=True)
    return c, stats, jc, jstats


# ---------------------------------------------------------------------------
# Verilog: golden files, both styles, full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("addend,pipeline,fname", [
    (True, "zeros,addends", "nn_inference_3x3.v"),
    (False, "zeros", "nn_inference_3x3_mult.v")])
def test_verilog_golden_byte_for_byte(addend, pipeline, fname):
    with open(os.path.join(GOLDEN, fname)) as f:
        want = f.read()
    art = netgen.Session(device="cpu").compile(
        _port(_golden_net()), target=f"verilog[addend={str(addend).lower()}]",
        pipeline=pipeline)
    assert art.kind == "text" and art.artifact == want
    with pytest.raises(TypeError):
        art(np.zeros((1, 3), np.uint8))
    with pytest.raises(TypeError):
        art.plan()


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("sizes", SMALL, ids=str)
def test_small_nets_circuits_and_verilog_identical(sizes, pipeline):
    c, stats, jc, jstats = _compiled(sizes, pipeline)
    assert _nodes(c) == _nodes(jc)
    assert _rows(stats) == _rows(jstats)
    for style in ("generic", "auto"):
        text = emit_verilog(c, style=style)
        assert text == jemit_verilog(jc, style=style), style
        assert "*" not in text.split(");", 1)[1] or pipeline == "default"
    if pipeline == "hw":
        with pytest.raises(netgen.IrregularCircuitError):
            emit_verilog(c, style="legacy")


def _v0_net():
    """The 784-500-10 net chip_smoke.py serves as v0 (seed 1, |w| <= 9)."""
    r = np.random.default_rng(1)
    return jquantize.QuantizedNet(
        w1=jquantize.int_cast_weights(r.normal(0, 784 ** -0.5, (784, 500))),
        w2=jquantize.int_cast_weights(r.normal(0, 500 ** -0.5, (500, 10))))


def test_full_width_verilog_cost_and_proof_identical():
    jnet = _v0_net()
    r = np.random.default_rng(1)
    port_ws = [quantize.int_cast_weights(r.normal(0, 784 ** -0.5, (784, 500))),
               quantize.int_cast_weights(r.normal(0, 500 ** -0.5, (500, 10)))]
    for a, b in zip(port_ws, jnet.weights):
        np.testing.assert_array_equal(a, b)
    net = quantize.from_numpy(port_ws)
    spec = "zeros,prune,addends"
    session, jsession = netgen.Session(device="cpu"), jnetgen.Session()
    verilog = session.compile(net, target="verilog", pipeline=spec)
    jverilog = jsession.compile(jnet, target="verilog", pipeline=spec)
    assert verilog.artifact == jverilog.artifact
    assert verilog.artifact.startswith(
        "// Auto-generated by repro.core.netgen — do not edit.\n"
        "// 784-500-10 feed-forward classifier, clockless.\n")
    cost = session.compile(net, target="cost", pipeline=spec)
    jcost = jsession.compile(jnet, target="cost", pipeline=spec)
    assert cost.kind == "report"
    assert cost.artifact.as_dict() == jcost.artifact.as_dict()
    assert cost.artifact.report() == jcost.artifact.report()
    assert netgen.CostReport.from_dict(cost.artifact.as_dict()) == cost.artifact
    assert [n for n, _ in cost.artifact.per_pass] == \
        ["lowered", "zeros", "prune", "addends"]
    assert cost.analysis == jcost.analysis == verilog.analysis
    assert cost.analysis["int32_safe"] and cost.pass_stats[-1].after.mults == 0
    assert cost.cost == cost.artifact.final
    assert cost.report() == jcost.report()
    assert set(cost.timings) == set(jcost.timings)


# ---------------------------------------------------------------------------
# Adder sharing, pipelines and fingerprints
# ---------------------------------------------------------------------------

def test_cse_exhaustive_node_for_node():
    w1 = np.array([[1, 1], [1, 1], [1, 1], [1, 0]], np.int32)
    w2 = np.ones((2, 2), np.int32)
    c = netgen.lower([w1, w2], input_threshold=128)
    jc = jnetgen.lower([w1, w2], input_threshold=128)
    shared, stats = netgen.run_pipeline(c, (netgen.share_common_addends,),
                                        verify=True)
    jshared, jstats = jnetgen.run_pipeline(jc, (jnetgen.share_common_addends,))
    assert _nodes(shared) == _nodes(jshared)
    assert _rows(stats) == _rows(jstats)
    assert netgen.ops(shared).adds < netgen.ops(c).adds
    x = images(1, 32, 4)
    np.testing.assert_array_equal(netgen.evaluate(shared, x),
                                  netgen.evaluate(c, x))


def _cse_784_net():
    rng = np.random.default_rng(0)
    return jquantize.QuantizedNet(weights=[
        rng.integers(-2, 3, size=(784, 4)).astype(np.int32),
        rng.integers(-2, 3, size=(4, 10)).astype(np.int32)])


def test_cse_bucketed_784_inputs_node_for_node():
    jnet = _cse_784_net()
    spec = "zeros,cse[budget=8,bucketed=true]"
    shared, stats = netgen.PipelineSpec.parse(spec).run(netgen.lower(_port(jnet)))
    jshared, jstats = jnetgen.PipelineSpec.parse(spec).run(jnetgen.lower(jnet))
    assert stats[-1].name == "cse[bucketed=true,budget=8]"
    assert stats[-1].adds_saved > 0
    assert _nodes(shared) == _nodes(jshared)
    assert _rows(stats) == _rows(jstats)
    text = emit_verilog(shared)
    assert "// shared sub-sums (common-addend CSE)" in text
    assert text == jemit_verilog(jshared)
    x = images(0, 24, 784)
    want = quantize.predict_quantized(_port(jnet), device="cpu")(x).numpy()
    np.testing.assert_array_equal(netgen.evaluate(shared, x), want)
    with pytest.raises(netgen.IrregularCircuitError):
        netgen.Session(device="cpu").compile(_port(jnet), target="cuda",
                                              pipeline=spec)


@pytest.mark.parametrize("spec", ["cse[budget=8,bucketed=true]", "hw",
                                  "zeros,cse[bucketed,budget=8]",
                                  "share_common_addends[budget=3]",
                                  "default", "zeros,prune,addends"])
def test_spec_strings_and_fingerprints_identical(spec):
    p, q = netgen.PipelineSpec.coerce(spec), jnetgen.PipelineSpec.coerce(spec)
    assert p.spec_string() == q.spec_string()
    assert p.fingerprint() == q.fingerprint()
    assert netgen.PipelineSpec.parse(p.spec_string()) == p


def test_registries_and_bad_specs():
    assert netgen.list_pipelines() == {
        k: v for k, v in jnetgen.list_pipelines().items()
        if k in ("default", "hw")}
    assert [p.name for p in netgen.list_passes()] == \
        [p.name for p in jnetgen.list_passes()]
    for bad in ("cse[budget=x]", "cse[bucketed=3]", "cse[depth=2]",
                "cse[budget=2", "mypkg.passes.retime", "zeros,zeros"):
        with pytest.raises(ValueError):
            netgen.PipelineSpec.coerce(bad)
    with pytest.raises(TypeError):
        netgen.PipelineSpec.coerce([netgen.delete_zero_terms])


# ---------------------------------------------------------------------------
# Interpreter and codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", PIPELINES[:2] + ["zeros,cse[budget=6]"])
@pytest.mark.parametrize("sizes", SIZES[:2], ids=str)
def test_evaluate_both_step_semantics_identical(sizes, pipeline):
    jnet = _small_net(sizes)
    jc, _ = jnetgen.PipelineSpec.coerce(pipeline).run(jnetgen.lower(jnet))
    c, _ = netgen.PipelineSpec.coerce(pipeline).run(netgen.lower(_port(jnet)))
    x = images(3, 64, sizes[0])
    for sem in ("strict", "msb"):
        got = netgen.evaluate(c, x, step_semantics=sem, check_widths=True)
        want = jnetgen.evaluate(jc, x, step_semantics=sem, check_widths=True)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=sem)
    np.testing.assert_array_equal(
        netgen.evaluate(c, x),
        quantize.predict_quantized(_port(jnet), device="cpu")(x).numpy())
    with pytest.raises(ValueError):
        netgen.evaluate(c, x, step_semantics="msb-ish")


def test_step_semantics_diverge_only_at_zero():
    w1 = np.array([[1], [-1]], np.int32)
    w2 = np.array([[0, 1]], np.int32)
    c = netgen.lower([w1, w2], input_threshold=128)
    jc = jnetgen.lower([w1, w2], input_threshold=128)
    x = np.array([[255, 255], [255, 0], [0, 0]], np.uint8)
    for sem in ("strict", "msb"):
        np.testing.assert_array_equal(netgen.evaluate(c, x, step_semantics=sem),
                                      jnetgen.evaluate(jc, x, step_semantics=sem))
    assert netgen.evaluate(c, x[:1], step_semantics="strict")[0] == 0
    assert netgen.evaluate(c, x[:1], step_semantics="msb")[0] == 1


@pytest.mark.parametrize("pipeline", ["default", "zeros,prune,addends",
                                      "zeros,cse[budget=6]"])
def test_codec_identical_and_round_trips(pipeline):
    jnet = _small_net((45, 21, 7))
    jc, _ = jnetgen.PipelineSpec.coerce(pipeline).run(jnetgen.lower(jnet))
    c, _ = netgen.PipelineSpec.coerce(pipeline).run(netgen.lower(_port(jnet)))
    arrays, jarrays = netgen.circuit_to_arrays(c), jnetgen.circuit_to_arrays(jc)
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        assert arrays[k].dtype == jarrays[k].dtype, k
        np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)
    assert netgen.circuit_from_arrays(arrays) == c
    assert _nodes(netgen.circuit_from_arrays(jarrays)) == _nodes(jc)
    bad = dict(arrays, kinds=np.where(arrays["kinds"] == 3, 7, arrays["kinds"]))
    with pytest.raises(ValueError):
        netgen.circuit_from_arrays(bad)


# ---------------------------------------------------------------------------
# Analysis: ranges, proofs, verifiers, stack diagnosis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("sizes", SMALL[:3], ids=str)
def test_ranges_and_proof_summary_identical(sizes, pipeline):
    c, _, jc, _ = _compiled(sizes, pipeline)
    ra, jra = analysis.analyze_ranges(c), janalysis.analyze_ranges(jc)
    assert {k: dataclasses.astuple(r) for k, r in ra.ranges.items()} == \
        {k: dataclasses.astuple(r) for k, r in jra.ranges.items()}
    assert ra.bounds() == jra.bounds() == netgen.graph.value_bounds(c)
    assert ra.widths() == jra.widths() == netgen.node_widths(c)
    assert ra.output_envelope(c) == jra.output_envelope(jc)
    assert analysis.check_ranges(c, ra) == []
    summary = analysis.proof_summary(c, ra)
    assert summary == janalysis.proof_summary(jc, jra)
    assert analysis.summary_row(summary) == janalysis.summary_row(summary)
    analysis.check_observed(c, images(4, 32, c.n_inputs), ranges=ra)


def _checks(diags):
    return sorted((d.check, d.node) for d in diags)


def test_verify_circuit_diagnostics_identical():
    jnet = random_net(3, (12, 9, 4), lo=-5, hi=5)
    c, jc = netgen.lower(_port(jnet)), jnetgen.lower(jnet)
    cases = {
        "dup": lambda k: dataclasses.replace(k, nodes=k.nodes + (k.nodes[0],)),
        "noout": lambda k: dataclasses.replace(k, output=k.nodes[0].id),
        "unsorted": lambda k: dataclasses.replace(k, nodes=k.nodes[::-1]),
    }
    for name, corrupt in cases.items():
        got = analysis.verify_circuit(corrupt(c), stage=name, collect=True)
        want = janalysis.verify_circuit(corrupt(jc), stage=name, collect=True)
        assert got and _checks(got) == _checks(want), name
        assert [d.row() for d in got] == [d.row() for d in want]
    for after in ("zeros", "addend_rewrite", "prune"):
        got = analysis.verify_circuit(c, after_pass=after, collect=True)
        want = janalysis.verify_circuit(jc, after_pass=after, collect=True)
        assert _checks(got) == _checks(want), after
    with pytest.raises(analysis.VerificationError, match="structure.output"):
        analysis.verify_circuit(cases["noout"](c))


def _corrupt_plans(circuit, lower):
    packed = lower(circuit, form="packed")
    w = packed.layers[0].weights.copy()
    w[-1, 0] = 1                                    # poison a zero-pad row
    pad = dataclasses.replace(packed, layers=(
        dataclasses.replace(packed.layers[0], weights=w),) + packed.layers[1:])
    planes = lower(circuit, form="planes")
    pos = planes.layers[0].pos_planes.copy()
    pos[0, 0, 0] ^= np.uint32(1)                   # flip one decomposed bit
    flip = dataclasses.replace(planes, layers=(
        dataclasses.replace(planes.layers[0], pos_planes=pos),) + planes.layers[1:])
    dense = lower(circuit, form="dense")
    chain = dataclasses.replace(dense, layers=dense.layers[1:])
    return {"pad": pad, "flip": flip, "chain": chain}


def test_verify_plan_diagnostics_identical():
    jnet = random_net(11, (20, 16, 4), lo=-5, hi=5)
    spec = "zeros,prune"
    c, _ = netgen.PipelineSpec.coerce(spec).run(netgen.lower(_port(jnet)))
    jc, _ = jnetgen.PipelineSpec.coerce(spec).run(jnetgen.lower(jnet))
    for form in ("dense", "packed", "planes"):
        assert lower_circuit(c, form=form).verify() == []
    bad, jbad = _corrupt_plans(c, lower_circuit), _corrupt_plans(jc, jlower_circuit)
    for name in bad:
        got = bad[name].verify(collect=True)
        want = jbad[name].verify(collect=True)
        assert got and [d.row() for d in got] == [d.row() for d in want], name
    with pytest.raises(analysis.VerificationError, match="plan.chain"):
        bad["chain"].verify()


def test_diagnose_stack_identical():
    def both(items):
        return analysis.diagnose_stack(items[0]), janalysis.diagnose_stack(items[1])

    twins = [random_net(s, (12, 9, 4), lo=-5, hi=5) for s in (20, 21)]
    odd = random_net(22, (12, 9, 5), lo=-5, hi=5)
    port = [netgen.lower(_port(n)) for n in twins + [odd]]
    ref = [jnetgen.lower(n) for n in twins + [odd]]
    shared = netgen.PipelineSpec.coerce("hw").run(port[0])[0]
    jshared = jnetgen.PipelineSpec.coerce("hw").run(ref[0])[0]
    cases = {
        "twins": (port[:2], ref[:2]),
        "classes": (port, ref),
        "irregular": ([shared], [jshared]),
        "form": ([lower_circuit(port[0], form="packed")],
                 [jlower_circuit(ref[0], form="packed")]),
        "empty": ([], []),
    }
    for name, items in cases.items():
        rep, jrep = both(items)
        assert (rep.compatible, rep.n_versions, rep.reason) == \
            (jrep.compatible, jrep.n_versions, jrep.reason), name
        assert rep.describe() == jrep.describe(), name
    assert both(cases["twins"])[0].compatible


def test_netserver_records_stack_reports():
    session = netgen.Session(device="cpu")
    server = netgen.NetServer(session=session, slot_capacity=8)
    a, b = random_net(25, (12, 9, 4)), random_net(26, (12, 9, 5))
    server.register("a", _port(a))
    server.register("b", _port(b))
    x = images(3, 4, 12)
    out = server.predict_many({"a": x, "b": x})
    assert server.dispatch_counts["fallback"] == 1
    rep = server.stack_report(["b", "a"])
    assert rep is not None and not rep.compatible
    assert rep.reason == "stack.classes"
    assert server.stack_report() == {("a", "b"): rep}
    np.testing.assert_array_equal(
        out["a"], quantize.predict_quantized(_port(a), device="cpu")(x).numpy())
    server.register("c", _port(random_net(27, (12, 9, 4))))
    assert server.stack_report() == {}              # registry change clears
    server.predict_many({"a": x, "c": x})
    assert server.stack_report(("a", "c")) is None  # stacked fine
    fused = netgen.NetServer(session=session, target="fused", slot_capacity=8)
    fused.register("a", _port(a))
    fused.register("c", _port(random_net(27, (12, 9, 4))))
    fused.predict_many({"a": x, "c": x})
    assert fused.stack_report(("a", "c")).reason == "stack.target"


# ---------------------------------------------------------------------------
# Verification at the pass boundary and in the compile driver
# ---------------------------------------------------------------------------

def _kind(n):
    return type(n).__name__


def drop_used_bit(circuit):
    """Corruption, structural class: deletes an InputCompare that a
    WeightedSum still reads. Written against node kind names, so it
    corrupts either package's circuits."""
    used = {t.src for n in circuit.nodes
            if _kind(n) == "WeightedSum" for t in n.terms}
    keep, dropped = [], False
    for n in circuit.nodes:
        if not dropped and _kind(n) == "InputCompare" and n.id in used:
            dropped = True
            continue
        keep.append(n)
    assert dropped
    return dataclasses.replace(circuit, nodes=tuple(keep))


def triple_final_weights(circuit):
    """Corruption, range class: scales the output-layer weights 3x, which
    widens the class score envelope."""
    finals = set(circuit.node(circuit.output).srcs)
    return dataclasses.replace(circuit, nodes=tuple(
        dataclasses.replace(n, terms=tuple(
            dataclasses.replace(t, weight=t.weight * 3) for t in n.terms))
        if _kind(n) == "WeightedSum" and n.id in finals else n
        for n in circuit.nodes))


@pytest.fixture
def corrupting_passes(monkeypatch):
    from repro_torch.netgen import pipeline
    for fn in (drop_used_bit, triple_final_weights):
        monkeypatch.setitem(pipeline._PASS_REGISTRY, fn.__name__,
                            PassDef(name=fn.__name__, fn=fn))


def test_pipeline_catches_corruption_at_the_pass_boundary(corrupting_passes):
    jnet = random_net(0, (12, 9, 4), lo=-5, hi=5)
    c = netgen.lower(_port(jnet))
    with pytest.raises(analysis.VerificationError) as ei:
        netgen.PipelineSpec.parse("zeros,drop_used_bit").run(c, verify=True)
    d = next(d for d in ei.value.diagnostics if d.check == "structure.topo-order")
    assert d.stage == "drop_used_bit" and d.node is not None
    with pytest.raises(janalysis.VerificationError) as jei:
        jnetgen.PipelineSpec.coerce(
            [jnetgen.delete_zero_terms, drop_used_bit]).run(
                jnetgen.lower(jnet), verify=True)
    assert _checks(ei.value.diagnostics) == _checks(jei.value.diagnostics)

    with pytest.raises(analysis.VerificationError) as ei:
        netgen.PipelineSpec.parse("triple_final_weights").run(c, verify=True)
    assert {d.check for d in ei.value.diagnostics} == {"range.envelope"}
    assert "widened" in ei.value.diagnostics[0].message
    out, _ = netgen.PipelineSpec.parse("triple_final_weights").run(c, verify=False)
    assert isinstance(out, netgen.Circuit)


def test_strict_compile_raises_on_corrupt_pipeline(corrupting_passes, monkeypatch):
    net = _port(random_net(33, (12, 9, 4), lo=-5, hi=5))
    monkeypatch.setenv("NETGEN_VERIFY", "0")
    art = netgen.Session(device="cpu").compile(net, target="torch",
                                               pipeline="triple_final_weights")
    assert art.pipeline == "triple_final_weights"   # production proceeds
    monkeypatch.setenv("NETGEN_VERIFY", "1")
    assert analysis.strict_verify()
    with pytest.raises(analysis.VerificationError, match="pre-backend|drop_used_bit"):
        netgen.Session(device="cpu").compile(net, target="torch",
                                             pipeline="drop_used_bit")


def test_artifact_carries_cost_analysis_and_timings():
    jnet = random_net(30, (12, 9, 4), lo=-5, hi=5)
    art = netgen.Session(device="cpu").compile(_port(jnet), target="torch")
    jart = jnetgen.Session().compile(jnet, target="jnp")
    assert art.kind == "callable" and art.plan_form == "dense"
    assert art.cost == art.cost.__class__(**{
        k: v for k, v in jart.cost.as_dict().items() if k != "total"})
    assert art.analysis == jart.analysis
    assert art.report() == jart.report()
    assert set(art.timings) == {"lower_s", "passes_s", "analysis_s",
                                "backend_s", "total_s"}
    assert all(v >= 0 for v in art.timings.values())
    assert art.plan().verify() == []
