"""Static analysis & verification for the netgen compiler.

Counterpart of `repro/netgen/analysis.py`. The paper's generated
hardware is only correct because every accumulator is sized to the
*exact* value range of the trained weights (§IV-§V: scaled inputs,
selected addends, the MSB sign step), and the card's kernels are only
exact because int32 accumulation cannot overflow. This module is the
machine-checked invariant layer behind both:

  Structural verifier — `verify_circuit`: DAG well-formedness (dense
      unique ids, topological order, src-reference validity), output
      wiring, kind-specific arity/field invariants (pixel ranges, step
      sources, argmax fan-in), and per-pass postconditions ("no
      zero-weight terms after `zeros`", "no |w| != 1 terms after
      `addends`", "no dead hidden units after `prune`"). Violations are
      `Diagnostic` records naming the check, the node, and the pipeline
      stage, raised together as one `VerificationError`.

  Range dataflow — `analyze_ranges`: one topological sweep computing,
      per node, the exact value interval [lo, hi] *and* the paper's
      symmetric magnitude bound sum(|w| * bound(src)) that sizes
      hardware registers. `check_ranges` proves that every WeightedSum
      fits its inferred `signed_width` and that the kernels' int32
      accumulation is safe at the actual fan-in.
      `RangeAnalysis.bounds()`/`widths()` reproduce
      `graph.value_bounds`/`graph.node_widths` exactly, so the Verilog
      and cost backends consume THIS analysis instead of recomputing.
      `check_observed` brackets every value the interpreter produces by
      the static interval.

  Plan certification — `verify_plan`: packed lane padding exactness
      (pad rows beyond the true fan-in are zero), `decompose_planes`
      losslessness (bit-planes reconstruct the int32 matrix bit for
      bit, positive/negative planes are disjoint, the plane count
      covers the post-pass magnitude range), layer chaining, and int32
      accumulation safety per layer.

  Stack compatibility — `diagnose_stack`: the structured report of WHY
      a set of model versions cannot share one stacked dispatch
      (irregular circuit, depth/threshold/input/class disagreement),
      which `NetServer` records instead of silently falling back.

  Store linter — `lint_store(root)` re-verifies every entry of an
      `ArtifactStore` directory (meta schema, circuit invariants and
      range proofs, content address, recomputed cost and proof summary,
      plan certification); `python -m repro_torch.netgen.analysis
      <store>` exits 0 when every entry is clean, 1 when one fails, and
      2 when there is no store.

Wiring: `PipelineSpec.run(verify=...)` checks invariants between
passes (default from the `NETGEN_VERIFY` env var — on in tests, off in
production); `Session.compile_resolved` always runs the range analysis
before the backend, raising under strict verification and otherwise
proceeding; the proof summary rides on the artifact and prints in
`artifact.report()`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.netgen.graph import (
    Argmax, Circuit, InputCompare, IrregularCircuitError, SignStep,
    WeightedSum, signed_width,
)
from repro_torch.netgen.plan import (
    ARGMAX, PACK_LANES, STEP, ExecutionPlan, lower_circuit,
)

__all__ = [
    "Diagnostic", "NodeRange", "RangeAnalysis", "StackReport",
    "VerificationError", "analyze", "analyze_ranges", "check_envelope",
    "check_observed", "check_ranges", "diagnose_stack", "lint_store",
    "main", "proof_summary", "strict_verify", "summary_row",
    "verify_circuit", "verify_plan",
]

_SUMMARY_FORMAT = "netgen-analysis-v1"
INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One invariant violation: which check, where, and why. `check` is
    a dotted invariant class ("structure.topo-order", "range.envelope",
    "plan.planes-lossless", "stack.depth", "store.key"); `stage` names
    the pipeline pass (or store entry) the violation was detected
    after, `node` the offending IR node when one exists."""
    check: str
    message: str
    node: int | None = None
    stage: str | None = None

    def row(self) -> str:
        where = ""
        if self.stage is not None:
            where += f" after {self.stage!r}"
        if self.node is not None:
            where += f" at node {self.node}"
        return f"[{self.check}]{where}: {self.message}"


class VerificationError(ValueError):
    """A batch of invariant violations, raised together so one broken
    pass reports every consequence, not just the first."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        shown = [d.row() for d in self.diagnostics[:8]]
        if len(self.diagnostics) > len(shown):
            shown.append(f"... and {len(self.diagnostics) - len(shown)} more")
        super().__init__(
            f"{len(self.diagnostics)} invariant violation(s):\n  "
            + "\n  ".join(shown))


def _finish(diags: list, collect: bool) -> list:
    if diags and not collect:
        raise VerificationError(diags)
    return diags


def strict_verify() -> bool:
    """Whether verification failures should raise (the `NETGEN_VERIFY`
    env var: on in tests via conftest, off in production where the
    compile driver proceeds past a failure)."""
    v = os.environ.get("NETGEN_VERIFY", "0").strip().lower()
    return v not in ("", "0", "false", "off", "no")


# ---------------------------------------------------------------------------
# Structural verifier
# ---------------------------------------------------------------------------

def _term_arrays(n: WeightedSum) -> tuple[np.ndarray, np.ndarray]:
    """(weights, srcs) of one accumulator as int64 arrays — the hot
    per-term sweeps (verifier, range dataflow, postconditions) are
    vectorized over these instead of looping Python-side (post-addend
    circuits carry sum(|w|) terms; a per-term interpreter loop made the
    analysis cost ~20% of pipeline time, numpy keeps it under 10%)."""
    k = len(n.terms)
    ws = np.fromiter((t.weight for t in n.terms), np.int64, count=k)
    srcs = np.fromiter((t.src for t in n.terms), np.int64, count=k)
    return ws, srcs


def _extract_terms(circuit: Circuit) -> list:
    """Term arrays for every node, aligned with `circuit.nodes` (None
    for non-accumulators). Extraction touches every Term once and
    dominates analysis cost, so `analyze` computes this list one time
    and threads it through the verifier, the postconditions, and the
    range sweep via their private `_terms` parameter."""
    return [_term_arrays(n) if isinstance(n, WeightedSum) else None
            for n in circuit.nodes]


def verify_circuit(circuit: Circuit, *, after_pass: str | None = None,
                   stage: str | None = None,
                   collect: bool = False,
                   _terms: list | None = None) -> list[Diagnostic]:
    """Check every structural invariant of the IR; with `after_pass`
    also the named pass's postconditions. Raises `VerificationError`
    unless `collect=True` (then the diagnostics are returned)."""
    diags: list[Diagnostic] = []

    def bad(check: str, message: str, node: int | None = None) -> None:
        diags.append(Diagnostic(
            check=check, message=message, node=node, stage=stage))

    # kind-by-id array for the vectorized per-term checks (0 = not yet
    # defined at this point of the topological sweep)
    max_id = max((n.id for n in circuit.nodes if n.id >= 0), default=-1)
    kind = np.zeros(max_id + 1, np.int8)
    _BIT, _SUM, _ARGMAX = 1, 2, 3

    terms = _extract_terms(circuit) if _terms is None else _terms
    seen: dict[int, object] = {}
    step_of: dict[int, int] = {}        # sum id -> step id
    pixels: dict[int, int] = {}         # pixel index -> node id
    for i, n in enumerate(circuit.nodes):
        if n.id in seen:
            bad("structure.duplicate-id", f"node id {n.id} defined twice",
                n.id)
        if isinstance(n, InputCompare):
            if not 0 <= n.pixel < circuit.n_inputs:
                bad("structure.input-pixel",
                    f"pixel {n.pixel} outside [0, {circuit.n_inputs})", n.id)
            elif n.pixel in pixels:
                bad("structure.input-pixel",
                    f"pixel {n.pixel} compared twice "
                    f"(also node {pixels[n.pixel]})", n.id)
            else:
                pixels[n.pixel] = n.id
            if not 0 <= n.threshold <= 255:
                bad("structure.input-threshold",
                    f"threshold {n.threshold} outside the uint8 range", n.id)
        elif isinstance(n, WeightedSum):
            if n.layer < 1:
                bad("structure.sum-layer",
                    f"layer tag {n.layer} < 1", n.id)
            _, srcs = terms[i]
            in_range = (srcs >= 0) & (srcs <= max_id)
            kinds = np.zeros(len(srcs), np.int8)
            kinds[in_range] = kind[srcs[in_range]]
            if not np.all(kinds > 0):          # fast path: all defined
                for s in sorted(set(srcs[kinds == 0].tolist())):
                    bad("structure.topo-order",
                        f"reads node {s} before it is defined", n.id)
            if np.any(kinds == _ARGMAX):
                for s in sorted(set(srcs[kinds == _ARGMAX].tolist())):
                    bad("structure.term-src",
                        f"term reads the Argmax node {s}", n.id)
        elif isinstance(n, SignStep):
            src = seen.get(n.src)
            if src is None:
                bad("structure.topo-order",
                    f"reads node {n.src} before it is defined", n.id)
            elif not isinstance(src, WeightedSum):
                bad("structure.step-src",
                    f"step source {n.src} is {type(src).__name__}, "
                    "not a WeightedSum", n.id)
            elif n.src in step_of:
                bad("structure.step-dup",
                    f"sum {n.src} already feeds step {step_of[n.src]}", n.id)
            else:
                step_of[n.src] = n.id
        elif isinstance(n, Argmax):
            if not n.srcs:
                bad("structure.argmax-arity", "argmax over zero scores", n.id)
            if len(set(n.srcs)) != len(n.srcs):
                bad("structure.argmax-dup",
                    "argmax reads a score twice", n.id)
            for s in n.srcs:
                src = seen.get(s)
                if src is None:
                    bad("structure.topo-order",
                        f"reads node {s} before it is defined", n.id)
                elif not isinstance(src, WeightedSum):
                    bad("structure.argmax-src",
                        f"score {s} is {type(src).__name__}, "
                        "not a WeightedSum", n.id)
        seen[n.id] = n
        if 0 <= n.id <= max_id:
            kind[n.id] = (_SUM if isinstance(n, WeightedSum)
                          else _ARGMAX if isinstance(n, Argmax) else _BIT)

    out = seen.get(circuit.output)
    if out is None or not isinstance(out, Argmax):
        bad("structure.output", "output must name an Argmax node",
            circuit.output)

    if after_pass is not None:
        post = _POSTCONDITIONS.get(after_pass)
        if post is not None:
            post(circuit, bad, terms)
    return _finish(diags, collect)


# -- per-pass postconditions (keyed by registry AND function name) ----------

def _post_zeros(circuit: Circuit, bad, terms: list) -> None:
    for i, n in enumerate(circuit.nodes):
        if isinstance(n, WeightedSum) and n.terms:
            ws, _ = terms[i]
            if not ws.all():
                bad("postcondition.zeros",
                    "zero-weight term survived delete_zero_terms", n.id)


def _post_addends(circuit: Circuit, bad, terms: list) -> None:
    for i, n in enumerate(circuit.nodes):
        if isinstance(n, WeightedSum) and n.terms:
            ws, _ = terms[i]
            nonunit = np.abs(ws) != 1
            if nonunit.any():
                w = int(ws[nonunit][0])
                bad("postcondition.addends",
                    f"non-unit weight {w} survived addend_rewrite", n.id)


def _post_prune(circuit: Circuit, bad, terms: list) -> None:
    consumed = {nid for nid, cs in circuit.consumers().items() if cs}
    by_id = circuit._by_id()
    out = by_id.get(circuit.output)
    final = set(out.srcs) if isinstance(out, Argmax) else set()
    for n in circuit.nodes:
        if isinstance(n, SignStep):
            src = by_id.get(n.src)
            if isinstance(src, WeightedSum) and not src.terms:
                bad("postcondition.prune",
                    f"step of the empty (constant-0) sum {n.src} survived "
                    "prune_dead_units", n.id)
            if n.id not in consumed:
                bad("postcondition.prune",
                    "unread hidden step survived prune_dead_units", n.id)
        elif isinstance(n, WeightedSum):
            if n.id not in consumed and n.id not in final:
                bad("postcondition.prune",
                    "unread hidden sum survived prune_dead_units", n.id)


_POSTCONDITIONS: dict[str, Callable] = {
    "zeros": _post_zeros, "delete_zero_terms": _post_zeros,
    "addends": _post_addends, "addend_rewrite": _post_addends,
    "prune": _post_prune, "prune_dead_units": _post_prune,
}


# ---------------------------------------------------------------------------
# Range dataflow
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeRange:
    """Per-node result of the dataflow: the exact value interval
    [lo, hi], the paper's symmetric magnitude bound (what hardware
    widths are sized from — `sum(|w| * bound(src))`, identical to
    `graph.value_bounds`), and the signed bit-width sized from it."""
    lo: int
    hi: int
    bound: int
    width: int

    @property
    def max_abs(self) -> int:
        return max(abs(self.lo), abs(self.hi))


@dataclasses.dataclass(frozen=True)
class RangeAnalysis:
    """The full per-node range map for one circuit, with the
    `value_bounds`/`node_widths`-compatible views the Verilog and cost
    backends consume (so wire widths come from ONE analysis)."""
    ranges: dict[int, NodeRange]

    def __getitem__(self, nid: int) -> NodeRange:
        return self.ranges[nid]

    def bounds(self) -> dict[int, int]:
        """Per-node magnitude bound — exactly `graph.value_bounds`."""
        return {nid: r.bound for nid, r in self.ranges.items()}

    def widths(self) -> dict[int, int]:
        """Per-node signed bit-width — exactly `graph.node_widths`."""
        return {nid: r.width for nid, r in self.ranges.items()}

    def output_envelope(self, circuit: Circuit) -> tuple:
        """The (lo, hi) interval of every class score, in argmax
        order — the quantity an exact rewrite may tighten but never
        widen (the pipeline verifier's cross-pass invariant)."""
        out = circuit.node(circuit.output)
        if not isinstance(out, Argmax):
            return ()
        return tuple((self.ranges[s].lo, self.ranges[s].hi)
                     for s in out.srcs)


def analyze_ranges(circuit: Circuit, *,
                   _terms: list | None = None) -> RangeAnalysis:
    """One topological sweep computing every node's `NodeRange` with
    exact integer interval arithmetic (see module doc). Terms reading
    an undefined source contribute nothing — structural breakage is
    `verify_circuit`'s to report; this sweep must not crash on the
    circuit it is diagnosing."""
    terms = _extract_terms(circuit) if _terms is None else _terms
    ranges: dict[int, NodeRange] = {}
    # id-indexed interval arrays for the vectorized accumulator sweep
    # (undefined srcs read a 0-everything slot and contribute nothing)
    max_id = max((n.id for n in circuit.nodes if n.id >= 0), default=-1)
    lo_a = np.zeros(max_id + 1, np.int64)
    hi_a = np.zeros(max_id + 1, np.int64)
    bd_a = np.zeros(max_id + 1, np.int64)
    for i, n in enumerate(circuit.nodes):
        if isinstance(n, (InputCompare, SignStep)):
            ranges[n.id] = NodeRange(lo=0, hi=1, bound=1, width=1)
            if 0 <= n.id <= max_id:
                hi_a[n.id] = bd_a[n.id] = 1
        elif isinstance(n, WeightedSum):
            ws, srcs = terms[i]
            ok = (srcs >= 0) & (srcs <= max_id)
            if not ok.all():
                ws, srcs = ws[ok], srcs[ok]
            slo, shi = lo_a[srcs], hi_a[srcs]
            pos = ws >= 0
            lo = int(np.where(pos, ws * slo, ws * shi).sum())
            hi = int(np.where(pos, ws * shi, ws * slo).sum())
            bound = int((np.abs(ws) * bd_a[srcs]).sum())
            ranges[n.id] = NodeRange(
                lo=lo, hi=hi, bound=bound, width=signed_width(bound))
            if 0 <= n.id <= max_id:
                lo_a[n.id], hi_a[n.id], bd_a[n.id] = lo, hi, bound
        elif isinstance(n, Argmax):
            k = len(n.srcs)
            ranges[n.id] = NodeRange(
                lo=0, hi=max(k - 1, 0), bound=max(k - 1, 1),
                width=max(math.ceil(math.log2(max(k, 2))), 1))
    return RangeAnalysis(ranges=ranges)


def check_ranges(circuit: Circuit, ranges: RangeAnalysis | None = None, *,
                 stage: str | None = None,
                 collect: bool = False) -> list[Diagnostic]:
    """Prove every accumulator fits its inferred signed width and stays
    int32-safe (the popcount kernel accumulates int32 at the actual
    fan-in). The width proof is the theorem the Verilog backend relies
    on: interval ⊆ [-2^(w-1), 2^(w-1) - 1]."""
    if ranges is None:
        ranges = analyze_ranges(circuit)
    diags: list[Diagnostic] = []
    for n in circuit.nodes:
        if not isinstance(n, WeightedSum):
            continue
        r = ranges.ranges.get(n.id)
        if r is None:
            diags.append(Diagnostic(
                check="range.missing", stage=stage, node=n.id,
                message="no range computed for accumulator"))
            continue
        lim = 1 << (r.width - 1)
        if r.lo < -lim or r.hi > lim - 1:
            diags.append(Diagnostic(
                check="range.width-overflow", stage=stage, node=n.id,
                message=f"interval [{r.lo}, {r.hi}] does not fit the "
                        f"inferred {r.width}-bit signed register"))
        if r.bound > INT32_MAX:
            diags.append(Diagnostic(
                check="range.int32", stage=stage, node=n.id,
                message=f"magnitude bound {r.bound} exceeds int32 — the "
                        "popcount kernel's accumulator would overflow"))
    return _finish(diags, collect)


def check_envelope(before: tuple, after: tuple, *, stage: str | None = None,
                   collect: bool = False) -> list[Diagnostic]:
    """Cross-pass invariant: an exact rewrite may tighten a class
    score's interval (pruning a constant-0 unit drops its slack) but
    must never widen it — a widened envelope means the pass changed
    the arithmetic (mis-sized a weight, dropped a source)."""
    diags: list[Diagnostic] = []
    if len(before) != len(after):
        diags.append(Diagnostic(
            check="range.class-count", stage=stage,
            message=f"pass changed the class count: "
                    f"{len(before)} -> {len(after)}"))
        return _finish(diags, collect)
    for k, ((blo, bhi), (alo, ahi)) in enumerate(zip(before, after)):
        if alo < blo or ahi > bhi:
            diags.append(Diagnostic(
                check="range.envelope", stage=stage,
                message=f"class {k} score interval widened from "
                        f"[{blo}, {bhi}] to [{alo}, {ahi}] — the rewrite "
                        "is not value-preserving"))
    return _finish(diags, collect)


def check_observed(circuit: Circuit, x_uint8, *,
                   step_semantics: str = "strict",
                   ranges: RangeAnalysis | None = None) -> None:
    """Execute the circuit on a uint8 batch and check every observed
    node value against its static interval — the dynamic face of the
    range analysis (subsumes `evaluate(check_widths=True)`: the
    interval is proven to fit the width by `check_ranges`, so any
    bracketed value fits too). Raises `VerificationError` on escape."""
    if ranges is None:
        ranges = analyze_ranges(circuit)
    x = np.asarray(x_uint8)
    vals: dict[int, np.ndarray] = {}
    diags: list[Diagnostic] = []
    for n in circuit.nodes:
        if isinstance(n, InputCompare):
            vals[n.id] = (
                x[:, n.pixel].astype(np.int64) > n.threshold).astype(np.int64)
        elif isinstance(n, WeightedSum):
            acc = np.zeros(x.shape[0], dtype=np.int64)
            for t in n.terms:
                acc += t.weight * vals[t.src]
            vals[n.id] = acc
        elif isinstance(n, SignStep):
            v = vals[n.src]
            vals[n.id] = (
                v > 0 if step_semantics == "strict" else v >= 0
            ).astype(np.int64)
        elif isinstance(n, Argmax):
            vals[n.id] = np.argmax(
                np.stack([vals[s] for s in n.srcs], axis=1), axis=1)
        r = ranges.ranges[n.id]
        v = vals[n.id]
        lo, hi = int(v.min(initial=0)), int(v.max(initial=0))
        if lo < r.lo or hi > r.hi:
            diags.append(Diagnostic(
                check="range.observed", node=n.id,
                message=f"observed values span [{lo}, {hi}] outside the "
                        f"static interval [{r.lo}, {r.hi}]"))
    _finish(diags, collect=False)


def analyze(circuit: Circuit, *, after_pass: str | None = None,
            stage: str | None = None, collect: bool = False
            ) -> tuple[RangeAnalysis, list[Diagnostic]]:
    """The compile driver's one-shot: structural verification + range
    proofs in a single call. Returns (ranges, diagnostics); raises
    unless `collect=True`."""
    terms = _extract_terms(circuit)
    diags = verify_circuit(circuit, after_pass=after_pass, stage=stage,
                           collect=True, _terms=terms)
    ranges = analyze_ranges(circuit, _terms=terms)
    diags += check_ranges(circuit, ranges, stage=stage, collect=True)
    return ranges, _finish(diags, collect)


# ---------------------------------------------------------------------------
# Proof summary (persisted with the Artifact)
# ---------------------------------------------------------------------------

def proof_summary(circuit: Circuit,
                  ranges: RangeAnalysis | None = None) -> dict:
    """The JSON-stable certificate `Session.compile_resolved` stamps on
    every Artifact: what the range analysis
    proved about the shipped circuit. `slack_bits` totals the bits the
    symmetric sizing bound spends beyond what the exact intervals need
    — the headroom a future interval-sized emitter could reclaim."""
    if ranges is None:
        ranges = analyze_ranges(circuit)
    sums = [n for n in circuit.nodes if isinstance(n, WeightedSum)]
    layer_widths: dict[str, int] = {}
    max_abs = 0
    slack = 0
    for n in sums:
        r = ranges.ranges[n.id]
        key = str(n.layer)
        layer_widths[key] = max(layer_widths.get(key, 0), r.width)
        max_abs = max(max_abs, r.max_abs)
        slack += r.width - signed_width(r.max_abs)
    return {
        "format": _SUMMARY_FORMAT,
        "nodes": len(circuit.nodes),
        "sum_nodes": len(sums),
        "terms": sum(len(n.terms) for n in sums),
        "max_width": max((layer_widths[k] for k in layer_widths), default=0),
        "max_abs_acc": max_abs,
        "layer_widths": layer_widths,
        "slack_bits": slack,
        "int32_safe": all(
            ranges.ranges[n.id].bound <= INT32_MAX for n in sums),
        "verified": True,
    }


def summary_row(summary: Mapping) -> str:
    """One-line rendering of a proof summary for `artifact.report()`."""
    return (f"analysis: proved {summary['sum_nodes']} accumulators fit "
            f"<= {summary['max_width']} bits (max |acc| "
            f"{summary['max_abs_acc']}, slack {summary['slack_bits']} bits, "
            f"int32_safe={str(bool(summary['int32_safe'])).lower()})")


# ---------------------------------------------------------------------------
# ExecutionPlan certification
# ---------------------------------------------------------------------------

def _unpack_words(words: np.ndarray) -> np.ndarray:
    """uint32 (..., W, N) -> {0,1} int64 (..., W*32, N) (bit i of word j
    is packed lane 32*j + i, matching `plan.decompose_planes`)."""
    shifts = np.arange(PACK_LANES, dtype=np.uint32)
    bits = (words[..., :, None, :] >> shifts[None, :, None]) & np.uint32(1)
    lead = words.shape[:-2]
    return bits.reshape(
        *lead, words.shape[-2] * PACK_LANES, words.shape[-1]).astype(np.int64)


def verify_plan(plan: ExecutionPlan, *, stage: str | None = None,
                collect: bool = False) -> list[Diagnostic]:
    """Certify an ExecutionPlan's form invariants (see module doc):
    layer chaining, packed lane-padding exactness, bit-plane
    losslessness and magnitude coverage, int32 accumulation safety."""
    diags: list[Diagnostic] = []

    def bad(check: str, message: str, layer: int | None = None) -> None:
        where = message if layer is None else f"layer {layer}: {message}"
        diags.append(Diagnostic(check=check, message=where, stage=stage))

    if not plan.layers:
        bad("plan.empty", "plan has no layers")
        return _finish(diags, collect)

    for i, layer in enumerate(plan.layers):
        want_act = STEP if i < plan.depth - 1 else ARGMAX
        if layer.activation != want_act:
            bad("plan.activation",
                f"activation {layer.activation!r}, expected {want_act!r}", i)
        want_ndim = 3 if plan.stacked else 2
        if layer.weights.ndim != want_ndim:
            bad("plan.stacked",
                f"weights ndim {layer.weights.ndim}, expected {want_ndim}", i)
            return _finish(diags, collect)
        if plan.stacked and layer.weights.shape[0] != plan.n_models:
            bad("plan.stacked",
                f"model axis {layer.weights.shape[0]} != n_models "
                f"{plan.n_models}", i)

    # layer chaining: fan_in of layer l+1 equals fan_out of layer l
    # (padded up to a lane multiple in the packed forms); layer 0 reads
    # the binarized inputs.
    def padded(k: int) -> int:
        if not plan.packed:
            return k
        return -(-k // PACK_LANES) * PACK_LANES if k else 0

    expect = padded(plan.n_inputs)
    true_fan_in = plan.n_inputs
    for i, layer in enumerate(plan.layers):
        if layer.fan_in != expect:
            bad("plan.chain",
                f"fan_in {layer.fan_in} != expected {expect} "
                "(predecessor fan_out)", i)
        if plan.packed:
            if layer.fan_in % PACK_LANES:
                bad("plan.pack",
                    f"packed fan_in {layer.fan_in} is not a multiple of "
                    f"{PACK_LANES}", i)
            if layer.words != layer.fan_in // PACK_LANES:
                bad("plan.pack",
                    f"words {layer.words} != fan_in // {PACK_LANES}", i)
            # lane padding exactness: every pad row must be zero, or a
            # padded activation bit could couple into a real score
            pad = layer.weights[..., true_fan_in:, :]
            if pad.size and np.any(pad != 0):
                bad("plan.pad-exact",
                    f"nonzero weights in the {layer.fan_in - true_fan_in} "
                    "zero-pad rows", i)
        if plan.bitplanes:
            _verify_planes(layer, i, bad)
        # int32 accumulation safety at the actual fan-in: the worst
        # column's sum of |w| bounds what the popcount kernel can
        # accumulate for one output
        mags = np.abs(layer.weights.astype(np.int64)).sum(axis=-2)
        worst = int(mags.max(initial=0))
        if worst > INT32_MAX:
            bad("plan.int32",
                f"max column magnitude {worst} exceeds int32", i)
        true_fan_in = layer.fan_out
        expect = padded(layer.fan_out)
    return _finish(diags, collect)


def _verify_planes(layer, i: int, bad) -> None:
    if layer.pos_planes is None or layer.neg_planes is None \
            or layer.n_planes is None:
        bad("plan.planes", "bit-plane form with no planes materialized", i)
        return
    if layer.pos_planes.shape != layer.neg_planes.shape:
        bad("plan.planes",
            f"pos/neg plane shapes differ: {layer.pos_planes.shape} vs "
            f"{layer.neg_planes.shape}", i)
        return
    if layer.pos_planes.shape[-3] != layer.n_planes:
        bad("plan.planes",
            f"plane axis {layer.pos_planes.shape[-3]} != n_planes "
            f"{layer.n_planes}", i)
        return
    mag = int(np.abs(layer.weights).max(initial=0))
    need = max(1, mag.bit_length())
    if layer.n_planes < need:
        bad("plan.planes-range",
            f"{layer.n_planes} planes cannot cover max |w| = {mag} "
            f"(needs {need})", i)
    if np.any(layer.pos_planes & layer.neg_planes):
        bad("plan.planes-disjoint",
            "a weight bit is set in both the positive and negative "
            "plane", i)
    # losslessness: the planes must reconstruct the int32 matrix bit
    # for bit — w = sum_b 2^b (unpack(pos_b) - unpack(neg_b))
    pos = _unpack_words(layer.pos_planes)
    neg = _unpack_words(layer.neg_planes)
    shifts = (1 << np.arange(layer.pos_planes.shape[-3], dtype=np.int64))
    recon = ((pos - neg)
             * shifts[:, None, None]).sum(axis=-3)
    if not np.array_equal(recon, layer.weights.astype(np.int64)):
        bad("plan.planes-lossless",
            "bit-plane decomposition does not reconstruct the weight "
            "matrix", i)


# ---------------------------------------------------------------------------
# Stack compatibility (consumed by the serving layer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackReport:
    """Why a version set can (or cannot) share one stacked dispatch.
    `diagnostics` is empty when `compatible`; otherwise each entry
    names the disagreeing axis (stack.depth / stack.threshold /
    stack.inputs / stack.classes) or the version whose circuit has no
    layered tensor form (stack.irregular)."""
    compatible: bool
    n_versions: int
    diagnostics: tuple = ()

    @property
    def reason(self) -> str:
        return self.diagnostics[0].check if self.diagnostics else "none"

    def describe(self) -> str:
        if self.compatible:
            return f"{self.n_versions} versions stack-compatible"
        return (f"{self.n_versions} versions cannot stack:\n  "
                + "\n  ".join(d.row() for d in self.diagnostics))


def diagnose_stack(items: Sequence) -> StackReport:
    """Structured stack-compatibility report over circuits or dense
    single-net plans — the checks `plan.stack_plans` enforces by
    raising, surfaced as diagnostics the serving layer records
    instead of swallowing."""
    diags: list[Diagnostic] = []
    plans: list[ExecutionPlan] = []
    for i, item in enumerate(items):
        if isinstance(item, ExecutionPlan):
            plans.append(item)
            continue
        try:
            plans.append(lower_circuit(item))
        except IrregularCircuitError as e:
            diags.append(Diagnostic(
                check="stack.irregular", stage=f"version {i}",
                message=str(e)))
    if not items:
        diags.append(Diagnostic(check="stack.empty",
                                message="no versions to stack"))
    if diags:
        return StackReport(compatible=False, n_versions=len(items),
                           diagnostics=tuple(diags))
    for i, p in enumerate(plans):
        if p.packed or p.stacked:
            diags.append(Diagnostic(
                check="stack.form", stage=f"version {i}",
                message="stacking takes dense single-net plans"))

    def axis(check: str, label: str, values: list) -> None:
        if len(set(values)) > 1:
            diags.append(Diagnostic(
                check=check,
                message=f"versions disagree on {label}: "
                        f"{sorted(set(values))}"))

    axis("stack.depth", "depth", [p.depth for p in plans])
    axis("stack.threshold", "input threshold",
         [p.input_threshold for p in plans])
    axis("stack.inputs", "input width", [p.n_inputs for p in plans])
    axis("stack.classes", "class count", [p.n_classes for p in plans])
    return StackReport(compatible=not diags, n_versions=len(items),
                       diagnostics=tuple(diags))


# ---------------------------------------------------------------------------
# ArtifactStore linter (`python -m repro_torch.netgen.analysis <store>`)
# ---------------------------------------------------------------------------

_META_REQUIRED = ("format", "digest", "pipeline", "target", "kind",
                  "pass_stats", "cost", "timings")


def lint_store(root) -> dict[str, list[Diagnostic]]:
    """Re-verify every entry of an `ArtifactStore` directory. Returns
    {key: diagnostics} for the entries that FAILED (clean stores map to
    {}). Checks: meta schema, circuit invariants + range proofs,
    content-address consistency (a mismatched key is a stale entry
    compiled by different sources or schema), recomputed cost and
    proof-summary agreement, plan-form certification for callables."""
    # lazy imports: session imports this module for the compile driver
    from repro_torch.netgen.backends.cost import logic_cells
    from repro_torch.netgen.graph import circuit_from_arrays
    from repro_torch.netgen.pipeline import PipelineSpec
    from repro_torch.netgen.session import _FORMAT, artifact_key

    root = Path(root).expanduser()
    if not root.is_dir():
        raise FileNotFoundError(f"no artifact store at {root}")
    failures: dict[str, list[Diagnostic]] = {}
    for entry in sorted(p for p in root.iterdir() if p.is_dir()):
        if entry.name.startswith(".tmp-"):
            continue
        diags = _lint_entry(entry, _FORMAT, artifact_key, PipelineSpec,
                            circuit_from_arrays, logic_cells)
        if diags:
            failures[entry.name] = diags
    return failures


def _lint_entry(entry: Path, fmt: str, artifact_key, PipelineSpec,
                circuit_from_arrays, logic_cells) -> list[Diagnostic]:
    key = entry.name
    diags: list[Diagnostic] = []

    def bad(check: str, message: str) -> None:
        diags.append(Diagnostic(check=check, message=message, stage=key[:12]))

    try:
        with open(entry / "meta.json") as f:
            meta = json.load(f)
    except Exception as e:
        bad("store.meta", f"unreadable meta.json: {e}")
        return diags
    if meta.get("format") != fmt:
        bad("store.format",
            f"format {meta.get('format')!r} != expected {fmt!r}")
        return diags
    missing = [k for k in _META_REQUIRED if k not in meta]
    if missing:
        bad("store.fields", f"meta.json missing {missing}")
        return diags

    try:
        with np.load(entry / "circuit.npz") as z:
            circuit = circuit_from_arrays(z)
    except Exception as e:
        bad("store.circuit", f"unreadable circuit.npz: {e}")
        return diags
    for d in verify_circuit(circuit, stage=key[:12], collect=True):
        diags.append(d)
    ranges = analyze_ranges(circuit)
    diags.extend(check_ranges(circuit, ranges, stage=key[:12], collect=True))

    try:
        spec = PipelineSpec.coerce(meta["pipeline"])
        want = artifact_key(meta["digest"], spec, meta["target"])
    except Exception as e:
        bad("store.key", f"cannot recompute content address: {e}")
        want = None
    if want is not None and want != key:
        bad("store.key",
            "stale entry: stored content address does not match the "
            "current compiler sources/spec (recompute "
            f"{want[:12]}... != {key[:12]}...)")

    cost = logic_cells(circuit, analysis=ranges).as_dict()
    if cost != meta["cost"]:
        bad("store.cost",
            f"recomputed cell estimate {cost} != stored {meta['cost']}")
    recorded = meta.get("analysis")
    if recorded is not None and recorded != proof_summary(circuit, ranges):
        bad("store.analysis",
            "stored proof summary does not match a recompute")
    if meta["kind"] == "text" and not (entry / "artifact.txt").exists():
        bad("store.artifact", "text artifact with no artifact.txt")
    if meta["kind"] == "callable":
        form = meta.get("plan_form") or "dense"
        if form not in ("dense", "packed", "planes"):
            bad("store.plan", f"unknown plan_form {form!r}")
        else:
            try:
                plan = lower_circuit(circuit, form=form)
            except IrregularCircuitError as e:
                bad("store.plan", f"callable artifact's circuit has no "
                                  f"layered form: {e}")
            else:
                diags.extend(verify_plan(plan, stage=key[:12], collect=True))
    return diags


def main(argv: Sequence[str] | None = None) -> int:
    """CLI: lint every artifact in a store directory; exit 0 when all
    entries verify, 1 with one structured diagnostic line per failure
    otherwise, 2 when there is no store at the path."""
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.netgen.analysis",
        description="lint every artifact in a netgen ArtifactStore")
    parser.add_argument("store", help="ArtifactStore root directory")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress the per-entry OK lines")
    args = parser.parse_args(argv)
    try:
        failures = lint_store(args.store)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    root = Path(args.store).expanduser()
    keys = sorted(p.name for p in root.iterdir()
                  if p.is_dir() and not p.name.startswith(".tmp-"))
    for key in keys:
        if key in failures:
            for d in failures[key]:
                print(f"FAIL {key[:12]} {d.row()}")
        elif not args.quiet:
            print(f"ok   {key[:12]}")
    n_bad = len(failures)
    print(f"linted {len(keys)} artifact(s): "
          f"{len(keys) - n_bad} ok, {n_bad} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
