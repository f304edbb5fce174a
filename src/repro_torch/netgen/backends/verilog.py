"""Verilog backend: emit a clockless combinational module from the IR.

Counterpart of `repro/netgen/backends/verilog.py`, emitting the same
text byte for byte. Two emission styles:

  * legacy  — the paper's regular 2-layer net (Figure 6 structure:
    `in*` comparators, `hi*` sums, `ho*` MSB steps, `fi*` sums,
    priority-mux `prediction`), with one shared signed width per layer
    exactly as the paper sizes its accumulators. Byte-identical to the
    golden files `tests/golden/nn_inference_3x3{,_mult}.v`, header
    comment included.
  * generic — any depth, and irregular (CSE-shared) DAGs: per-layer wire
    groups `s{l}_*` / `a{l}_*`, shared sub-sums `t*`, each wire sized by
    the per-node signed bit-width of the shared `RangeAnalysis`.

`style="auto"` (default) picks legacy whenever the circuit is the
regular 2-layer form and generic otherwise. Continuous assignments are
order-independent, so emission order is cosmetic.

Registered as the `verilog` target (kind "text"; declared options
`module_name`, `style`, `addend` — addressable as
`verilog[style=legacy]` etc.); see `repro_torch.netgen.targets`.
"""
from __future__ import annotations

import math

from repro_torch.netgen.analysis import RangeAnalysis, analyze_ranges
from repro_torch.netgen.graph import (
    Argmax, Circuit, InputCompare, IrregularCircuitError, SignStep,
    WeightedSum,
)
from repro_torch.netgen.plan import lower_circuit

__all__ = ["emit_verilog"]


def _sum_expr(terms, names) -> str:
    """Render one accumulator: signed sum of named sources, in term order.
    Unit weights print bare names (the multiplication-free form); other
    magnitudes print `|w|*name` (pre-L5 style)."""
    units: list[tuple[int, str]] = []
    for t in terms:
        name = names[t.src]
        mag = abs(t.weight)
        term = name if mag == 1 else f"{mag}*{name}"
        units.append((1 if t.weight > 0 else -1, term))
    if not units:
        return "0"
    parts = [units[0][1] if units[0][0] > 0 else f"-{units[0][1]}"]
    for sign, term in units[1:]:
        parts.append(("+ " if sign > 0 else "- ") + term)
    return " ".join(parts)


def _argmax_mux(n_out: int, pw: int, names: list[str]) -> str:
    """Priority chain of comparators computing argmax (first max wins) —
    the flat equivalent of the paper's single wide comparison LUT."""
    expr = f"{pw}'d{n_out-1}"
    for k in range(n_out - 2, -1, -1):
        conds = " && ".join(
            f"{names[k]} >= {names[m]}" for m in range(k + 1, n_out))
        expr = f"(({conds}) ? {pw}'d{k} : {expr})"
    return expr


def _layer_width(bounds: dict, layer_sums: list[WeightedSum]) -> int:
    """The original emitter's per-layer accumulator width: the max column
    sum of |w|, plus one, rounded up — `_acc_width` verbatim."""
    bound = max((bounds[n.id] for n in layer_sums), default=0) + 1
    return max(math.ceil(math.log2(bound + 1)) + 1, 2)


def _is_addend_form(circuit: Circuit) -> bool:
    return all(
        abs(t.weight) <= 1
        for n in circuit.by_kind(WeightedSum) for t in n.terms)


def emit_verilog(
    circuit: Circuit,
    *,
    module_name: str = "nn_inference",
    style: str = "auto",
    addend: bool | None = None,
    _analysis: RangeAnalysis | None = None,
) -> str:
    """Emit the circuit as a combinational Verilog module. `addend`
    controls only the header comment (None: detect from the terms).
    Accumulator widths come from the shared range analysis — the
    Session driver passes its pre-backend `RangeAnalysis` as
    `_analysis` (the verilog target declares `wants_analysis`), so the
    emitted widths are exactly the ones the analysis proved; direct
    callers get the same analysis computed here."""
    if style not in ("auto", "legacy", "generic"):
        raise ValueError(f"unknown style {style!r}")
    if addend is None:
        addend = _is_addend_form(circuit)
    ranges = analyze_ranges(circuit) if _analysis is None else _analysis
    if style in ("auto", "legacy"):
        try:
            if circuit.depth == 2:
                lower_circuit(circuit)       # regularity check only
                return _emit_legacy(circuit, module_name, addend, ranges)
        except IrregularCircuitError:
            if style == "legacy":
                raise
        if style == "legacy":
            raise IrregularCircuitError(
                "legacy style requires the regular 2-layer form")
    return _emit_generic(circuit, module_name, addend, ranges)


# ---------------------------------------------------------------------------
# Legacy style (paper Figure 6; byte-compatible with the seed emitter)
# ---------------------------------------------------------------------------

def _emit_legacy(circuit: Circuit, module_name: str, addend: bool,
                 ranges: RangeAnalysis) -> str:
    inputs = sorted(circuit.by_kind(InputCompare), key=lambda n: n.pixel)
    sums = circuit.by_kind(WeightedSum)
    hidden = [n for n in sums if n.layer == 1]
    final = [n for n in sums if n.layer == 2]
    steps = circuit.by_kind(SignStep)
    step_of = {s.src: s for s in steps}
    bounds = ranges.bounds()

    n_in, n_h, n_out = len(inputs), len(hidden), len(final)
    bw1, bw2 = _layer_width(bounds, hidden), _layer_width(bounds, final)
    pw = max(math.ceil(math.log2(n_out)), 1)

    names: dict[int, str] = {}
    for i, n in enumerate(inputs):
        names[n.id] = f"in{i}"
    for j, n in enumerate(hidden):
        names[n.id] = f"hi{j}"
        names[step_of[n.id].id] = f"ho{j}"
    for k, n in enumerate(final):
        names[n.id] = f"fi{k}"

    L: list[str] = []
    L.append(f"// Auto-generated by repro.core.netgen — do not edit.")
    L.append(f"// {n_in}-{n_h}-{n_out} feed-forward classifier, clockless.")
    L.append(f"module {module_name} (")
    L.append("    input  wire [7:0] " + ", ".join(f"px{i}" for i in range(n_in)) + ",")
    L.append(f"    output wire [{pw-1}:0] prediction")
    L.append(");")
    L.append(f"  wire " + ", ".join(f"in{i}" for i in range(n_in)) + ";")
    L.append(f"  wire signed [{bw1-1}:0] " + ", ".join(f"hi{j}" for j in range(n_h)) + ";")
    L.append(f"  wire " + ", ".join(f"ho{j}" for j in range(n_h)) + ";")
    L.append(f"  wire signed [{bw2-1}:0] " + ", ".join(f"fi{k}" for k in range(n_out)) + ";")
    L.append("")
    L.append("  // input comparators (paper L2: pixel > threshold)")
    for i, n in enumerate(inputs):
        L.append(f"  assign in{i} = (px{i} > {n.threshold}) ? 1'b1 : 1'b0;")
    L.append("")
    L.append("  // hidden-input sums (L4 pruned" + (", L5 addend form)" if addend else ")"))
    for j, n in enumerate(hidden):
        L.append(f"  assign hi{j} = {_sum_expr(n.terms, names)};")
    L.append("")
    L.append("  // step activation via sign bit (paper §V.D MSB trick)")
    for j in range(n_h):
        L.append(f"  assign ho{j} = ~hi{j}[{bw1-1}];")
    L.append("")
    L.append("  // final-input sums")
    for k, n in enumerate(final):
        L.append(f"  assign fi{k} = {_sum_expr(n.terms, names)};")
    L.append("")
    L.append("  // prediction: index of the maximum final input (paper Figure 6 line 15)")
    expr = _argmax_mux(n_out, pw, [f"fi{k}" for k in range(n_out)])
    L.append(f"  assign prediction = {expr};")
    L.append("endmodule")
    return "\n".join(L) + "\n"


# ---------------------------------------------------------------------------
# Generic style (any depth, irregular DAGs, per-node widths)
# ---------------------------------------------------------------------------

def _emit_generic(circuit: Circuit, module_name: str, addend: bool,
                  ranges: RangeAnalysis) -> str:
    inputs = sorted(circuit.by_kind(InputCompare), key=lambda n: n.pixel)
    sums = circuit.by_kind(WeightedSum)
    steps = circuit.by_kind(SignStep)
    argmax = circuit.node(circuit.output)
    assert isinstance(argmax, Argmax)
    step_of = {s.src: s for s in steps}
    widths = ranges.widths()
    depth = circuit.depth

    final_ids = set(argmax.srcs)
    final = [circuit.node(s) for s in argmax.srcs]
    # layer sums feed a step; shared CSE sub-sums feed other sums directly
    by_layer: dict[int, list[WeightedSum]] = {}
    shared: list[WeightedSum] = []
    for n in sums:
        if n.id in final_ids:
            continue
        (by_layer.setdefault(n.layer, []) if n.id in step_of else shared).append(n)

    names: dict[int, str] = {}
    for i, n in enumerate(inputs):
        names[n.id] = f"in{i}"
    for layer, group in sorted(by_layer.items()):
        for j, n in enumerate(group):
            names[n.id] = f"s{layer}_{j}"
            names[step_of[n.id].id] = f"a{layer}_{j}"
    for m, n in enumerate(shared):
        names[n.id] = f"t{m}"
    for k, n in enumerate(final):
        names[n.id] = f"fi{k}"

    n_in, n_out = len(inputs), len(final)
    sizes = [len(by_layer.get(l, [])) for l in range(1, depth)] + [n_out]
    pw = max(math.ceil(math.log2(n_out)), 1)

    def decl(group: list[WeightedSum]) -> list[str]:
        return [
            f"  wire signed [{widths[n.id]-1}:0] {names[n.id]};" for n in group]

    L: list[str] = []
    L.append("// Auto-generated by repro.netgen — do not edit.")
    L.append("// " + "-".join(str(s) for s in [n_in] + sizes)
             + " feed-forward classifier, clockless.")
    L.append(f"module {module_name} (")
    L.append("    input  wire [7:0] " + ", ".join(f"px{i}" for i in range(n_in)) + ",")
    L.append(f"    output wire [{pw-1}:0] prediction")
    L.append(");")
    L.append("  wire " + ", ".join(f"in{i}" for i in range(n_in)) + ";")
    for layer in sorted(by_layer):
        group = by_layer[layer]
        L.extend(decl(group))
        L.append("  wire " + ", ".join(names[step_of[n.id].id] for n in group) + ";")
    if shared:
        L.extend(decl(shared))
    L.extend(decl(final))
    L.append("")
    L.append("  // input comparators (paper L2: pixel > threshold)")
    for i, n in enumerate(inputs):
        L.append(f"  assign in{i} = (px{i} > {n.threshold}) ? 1'b1 : 1'b0;")
    if shared:
        L.append("")
        L.append("  // shared sub-sums (common-addend CSE)")
        for n in shared:
            L.append(f"  assign {names[n.id]} = {_sum_expr(n.terms, names)};")
    for layer in sorted(by_layer):
        group = by_layer[layer]
        L.append("")
        L.append(f"  // layer {layer} sums (L4 pruned"
                 + (", L5 addend form)" if addend else ")"))
        for n in group:
            L.append(f"  assign {names[n.id]} = {_sum_expr(n.terms, names)};")
        L.append(f"  // layer {layer} step activations via sign bit (§V.D MSB trick)")
        for n in group:
            s = names[step_of[n.id].id]
            L.append(f"  assign {s} = ~{names[n.id]}[{widths[n.id]-1}];")
    L.append("")
    L.append("  // final-input sums")
    for n in final:
        L.append(f"  assign {names[n.id]} = {_sum_expr(n.terms, names)};")
    L.append("")
    L.append("  // prediction: index of the maximum final input (priority mux)")
    expr = _argmax_mux(n_out, pw, [names[n.id] for n in final])
    L.append(f"  assign prediction = {expr};")
    L.append("endmodule")
    return "\n".join(L) + "\n"
