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
  share_common_addends  — CSE over addends: a (w_a·a + w_b·b) pair that
                          occurs in several accumulators is computed once
                          in a shared sub-sum node (adder sharing). Makes
                          the circuit an irregular DAG: fine for the
                          Verilog and cost targets and the interpreter,
                          rejected by the array backends.

`ops` counts a circuit's arithmetic and `PassStats` records one pass's
before/after counts. `run_pipeline` threads a circuit through a list of
pass callables; `PipelineSpec.run` is the spec-driven face of the same
loop.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Sequence

from repro_torch.netgen.graph import (
    Argmax, Circuit, SignStep, Term, WeightedSum,
)

Pass = Callable[[Circuit], Circuit]

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

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


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

    @property
    def terms_deleted(self) -> int:
        return self.before.terms - self.after.terms

    @property
    def adds_saved(self) -> int:
        return self.before.adds - self.after.adds

    def row(self) -> str:
        b, a = self.before, self.after
        return (f"{self.name}: terms {b.terms}->{a.terms}, "
                f"mults {b.mults}->{a.mults}, adds {b.adds}->{a.adds}, "
                f"nodes {b.nodes}->{a.nodes}")


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


def share_common_addends(circuit: Circuit, *, max_new_nodes: int = 4096,
                         bucketed: bool = False) -> Circuit:
    """Greedy two-term CSE: extract the most frequent addend pair into a
    shared sub-sum until no pair repeats (or max_new_nodes is hit).

    A pair key is the unordered combination of two distinct (weight, src)
    terms; a node counts each key at most once per round. Every extraction
    strictly reduces total adds (k co-occurrences save k adders and spend
    one in the shared node), so the loop terminates. Exact: the shared
    node computes precisely the sub-sum it replaces.

    The default (exhaustive) candidate search is O(sum_nodes * terms^2)
    per round and extracts ONE pair per round — intended for post-addend
    hardware circuits of moderate size. `bucketed=True` selects the
    scalable variant: per node, candidate pairs
    are indexed by their (sign, magnitude) weight bucket — only terms
    with the SAME signed weight pair up — so one counting sweep costs
    ~O(terms * bucket) instead of O(terms^2), and every pair that repeats
    is extracted in that same sweep (batch extraction) instead of one per
    round. Same-weight pairs are exactly the ones the addend form
    produces en masse, so on L5 circuits the restriction loses little
    sharing while making the full 784-input net tractable. Still an
    exact rewrite; still an irregular DAG result (see
    graph.IrregularCircuitError).
    """
    nodes = list(circuit.nodes)
    next_id = max(n.id for n in nodes) + 1
    created = 0

    while created < max_new_nodes:
        counts: Counter = Counter()
        for n in nodes:
            if not isinstance(n, WeightedSum):
                continue
            distinct = sorted(set(n.terms), key=lambda t: (t.src, t.weight))
            if bucketed:
                buckets: dict[int, list[Term]] = {}
                for t in distinct:
                    buckets.setdefault(t.weight, []).append(t)
                groups = buckets.values()
            else:
                groups = (distinct,)
            for group in groups:
                for i in range(len(group)):
                    for j in range(i + 1, len(group)):
                        counts[(group[i], group[j])] += 1

        if bucketed:
            repeated = [(pair, k) for pair, k in counts.most_common()
                        if k >= 2]
        else:
            # classic greedy: one pair per round (most_common(1) is a
            # heap scan, not a full sort of the O(terms^2) counter)
            repeated = [(pair, k) for pair, k in counts.most_common(1)
                        if k >= 2]
        if not repeated:
            break

        progressed = False
        for (ta, tb), _ in repeated:
            if created >= max_new_nodes:
                break
            # membership may have changed within this sweep — recheck
            hosts = [
                i for i, n in enumerate(nodes)
                if isinstance(n, WeightedSum)
                and ta in n.terms and tb in n.terms]
            if len(hosts) < 2:
                continue
            shared = WeightedSum(
                id=next_id, terms=(ta, tb),
                layer=min(nodes[i].layer for i in hosts))
            next_id += 1
            created += 1
            progressed = True

            for i in hosts:
                n = nodes[i]
                kept = list(n.terms)
                kept.remove(ta)
                kept.remove(tb)
                kept.append(Term(weight=1, src=shared.id))
                nodes[i] = dataclasses.replace(n, terms=tuple(kept))
            nodes.insert(min(hosts), shared)
        if not progressed:
            break

    out = dataclasses.replace(circuit, nodes=tuple(nodes))
    out.validate()
    return out


# ---------------------------------------------------------------------------
# Pipeline driver
# ---------------------------------------------------------------------------

# Exact rewrites safe for every backend (dense layered form preserved).
DEFAULT_PASSES: tuple[Pass, ...] = (delete_zero_terms, prune_dead_units)

# Full hardware pipeline: multiplication-free form plus adder sharing.
# Produces an irregular DAG — Verilog / interpreter only.
HW_PASSES: tuple[Pass, ...] = (
    delete_zero_terms, prune_dead_units, addend_rewrite, share_common_addends)


def run_pipeline(
    circuit: Circuit, passes: Sequence[Pass] = DEFAULT_PASSES,
    *, verify: bool = False,
) -> tuple[Circuit, tuple[PassStats, ...]]:
    """Apply `passes` in order, recording per-pass cost deltas.

    `verify=True` runs the `analysis` structural verifier
    (plus the pass's postconditions, matched by function name) after
    every pass — the list-of-callables face of `PipelineSpec.run(verify=)`.
    """
    if verify:
        from repro_torch.netgen import analysis
        analysis.verify_circuit(circuit, stage="lowered")
    stats = []
    for p in passes:
        before = ops(circuit)
        circuit = p(circuit)
        name = getattr(p, "__name__", str(p))
        if verify:
            analysis.verify_circuit(circuit, after_pass=name, stage=name)
        stats.append(PassStats(
            name=name, before=before,
            after=ops(circuit)))
    return circuit, tuple(stats)
