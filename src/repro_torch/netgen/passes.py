"""Optimization passes over the circuit IR, with per-pass statistics.

Counterpart of `repro/netgen/passes.py`. Each pass is a pure function
`Circuit -> Circuit` performing an *exact* rewrite (predictions are
unchanged under the strict step semantics). The paper's structural
tricks map onto them:

  delete_zero_terms     — paper L4, per-term: a `0 * x` addend is deleted
                          from the generated program (~50% of terms).
  prune_dead_units      — paper L4, per-unit: a hidden unit with no inputs
                          is constant 0 and vanishes downstream; a hidden
                          unit nothing reads is deleted outright.
  addend_rewrite        — paper L5: `w * x` with x in {0,1} becomes |w|
                          repeated ±x addends — multiplication-free form.

`ops` counts a circuit's arithmetic and `PassStats` records one pass's
before/after counts; `PipelineSpec.run` threads the passes. Adder
sharing (CSE) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

from repro_torch.netgen.graph import (
    Argmax, Circuit, SignStep, Term, WeightedSum,
)

# ---------------------------------------------------------------------------
# Cost model (the paper counts logic cells; we count the arithmetic the
# cell counts are proportional to)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CircuitOps:
    """Arithmetic cost of one circuit, per prediction."""
    nodes: int          # all IR nodes
    sum_nodes: int      # accumulators (the paper's hi/fi wires)
    terms: int          # weighted addends across all accumulators
    mults: int          # terms needing a real multiplier (|w| > 1)
    adds: int           # two-input adders: sum over nodes of (terms - 1)
    addend_units: int   # adders after full L5 expansion: sum of |w|


def ops(circuit: Circuit) -> CircuitOps:
    sums = circuit.by_kind(WeightedSum)
    terms = sum(len(n.terms) for n in sums)
    return CircuitOps(
        nodes=len(circuit.nodes),
        sum_nodes=len(sums),
        terms=terms,
        mults=sum(1 for n in sums for t in n.terms if abs(t.weight) > 1),
        adds=sum(max(len(n.terms) - 1, 0) for n in sums),
        addend_units=sum(abs(t.weight) for n in sums for t in n.terms),
    )


@dataclasses.dataclass(frozen=True)
class PassStats:
    """Before/after cost of one pass application."""
    name: str
    before: CircuitOps
    after: CircuitOps


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------

def delete_zero_terms(circuit: Circuit) -> Circuit:
    """Drop `0 * x` addends (paper L4 term deletion). Exact trivially."""
    nodes = tuple(
        dataclasses.replace(
            n, terms=tuple(t for t in n.terms if t.weight != 0))
        if isinstance(n, WeightedSum) else n
        for n in circuit.nodes)
    return dataclasses.replace(circuit, nodes=nodes)


def prune_dead_units(circuit: Circuit) -> Circuit:
    """Remove structurally dead hidden units (paper L4 unit deletion).

    * empty accumulator: value is constant 0, step(0) = 0 under the
      strict semantics, so every downstream term that reads its step
      contributes nothing — delete those terms, then the unit.
    * unread unit: a hidden step no accumulator reads (its output weights
      were all zero) is deleted with its accumulator.

    Final-layer accumulators and InputCompare nodes are never removed:
    the argmax needs every class score, and the input comparators are
    part of the module interface (the paper's Verilog keeps unused `in`
    wires too). Runs to fixpoint — removing one unit can strand another.
    """
    by_id = {n.id: n for n in circuit.nodes}
    final = set(by_id[circuit.output].srcs)

    while True:
        # steps whose accumulator is empty -> their value is constant 0
        zero_steps = {
            n.id for n in by_id.values()
            if isinstance(n, SignStep) and not by_id[n.src].terms}
        if zero_steps:
            for nid, n in list(by_id.items()):
                if isinstance(n, WeightedSum):
                    kept = tuple(t for t in n.terms if t.src not in zero_steps)
                    if len(kept) != len(n.terms):
                        by_id[nid] = dataclasses.replace(n, terms=kept)

        consumers: Counter = Counter()
        for n in by_id.values():
            if isinstance(n, WeightedSum):
                consumers.update(t.src for t in n.terms)
            elif isinstance(n, SignStep):
                consumers.update((n.src,))
            elif isinstance(n, Argmax):
                consumers.update(n.srcs)

        dead = {
            nid for nid, n in by_id.items()
            if consumers[nid] == 0
            and (isinstance(n, SignStep)
                 or (isinstance(n, WeightedSum) and nid not in final))}
        if not dead:
            break
        for nid in dead:
            del by_id[nid]

    nodes = tuple(by_id[n.id] for n in circuit.nodes if n.id in by_id)
    return dataclasses.replace(circuit, nodes=nodes)


def addend_rewrite(circuit: Circuit) -> Circuit:
    """Paper L5: expand `w * x` into |w| repeated ±1 addends. Exact; after
    this pass no accumulator needs a multiplier (`ops().mults == 0`)."""
    def expand(n: WeightedSum) -> WeightedSum:
        units = tuple(
            Term(weight=1 if t.weight > 0 else -1, src=t.src)
            for t in n.terms for _ in range(abs(t.weight)))
        return dataclasses.replace(n, terms=units)

    nodes = tuple(
        expand(n) if isinstance(n, WeightedSum) else n for n in circuit.nodes)
    return dataclasses.replace(circuit, nodes=nodes)
