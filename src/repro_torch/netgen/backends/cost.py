"""Cost target: walk the IR and estimate FPGA logic-cell usage.

Counterpart of `repro/netgen/backends/cost.py`, pricing every circuit
to the same cell. The paper reports its optimizations in *logic cells*
(Figure 7: >80k cells for the naive 784-500-10 circuit, ~38k after zero
pruning, <16k in the multiplication-free addend form). This backend
walks the circuit graph and prices each node with a simple 4-input-LUT
fabric model:

  InputCompare — an 8-bit magnitude comparator: `ceil(8/4) + 1` cells
                 (two 4-LUT slices plus the combining cell).
  WeightedSum  — a compressor (adder) tree. Summing N input *bits* down
                 to a W-bit result costs about `N - W` full adders, one
                 logic cell each; a term contributes `|w| * width(src)`
                 input bits (the |w| repeated addends the L5 rewrite
                 makes explicit — hardware pays them either way). A
                 `0 * x` term still occupies one adder slot (the paper's
                 generated module instantiates it before synthesis can
                 prove it zero — deleting them is exactly the L4 ~50%
                 cut), and every term with |w| > 1 prices its constant
                 multiplier at `width(src) * ceil(log2(|w|+1))` cells —
                 the cells the L5 addend rewrite deletes (38k -> <16k).
  SignStep     — free: the paper's §V.D trick reads the accumulator MSB.
  Argmax       — a priority chain of (n-1) W-bit comparators plus the
                 index mux: `(n-1) * (W + index_width)` cells.

The estimate is proportional, not gospel: its job is to rank rewrites
and track the paper's Figure-7 trajectory, which is why `CostReport`
carries the paper's reference counts alongside and, when compiled
through a `Session`, a per-pass breakdown (the cost of the circuit
after every pass boundary).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.netgen.graph import (
    Argmax, Circuit, InputCompare, SignStep, WeightedSum, value_bounds,
    signed_width,
)

__all__ = [
    "PAPER_FIG7_CELLS", "CellCounts", "CostReport", "compile_cost",
    "logic_cells",
]

LUT_INPUTS = 4

# Paper Figure 7, 784-500-10 net (approximate read-offs; see module doc).
PAPER_FIG7_CELLS = {"naive": 80000, "pruned": 38000, "addend": 16000}


@dataclasses.dataclass(frozen=True)
class CellCounts:
    """Logic-cell estimate for one circuit, split by structure."""
    compare_cells: int
    adder_cells: int
    mult_cells: int
    argmax_cells: int

    @property
    def total(self) -> int:
        return (self.compare_cells + self.adder_cells + self.mult_cells
                + self.argmax_cells)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total"] = self.total
        return d

    def row(self) -> str:
        return (f"cells {self.total} (compare {self.compare_cells}, "
                f"adders {self.adder_cells}, mults {self.mult_cells}, "
                f"argmax {self.argmax_cells})")


def logic_cells(circuit: Circuit, *, analysis=None) -> CellCounts:
    """Price one circuit with the LUT model in the module doc.

    `analysis`, when given, is the driver's pre-backend
    `repro_torch.netgen.analysis.RangeAnalysis`: its proven widths are used
    directly instead of re-deriving them from `value_bounds` (the two
    agree by construction — the analysis subsumes the ad-hoc width
    inference)."""
    if analysis is not None:
        width = analysis.widths()
    else:
        bounds = value_bounds(circuit)
        width = {
            nid: (1 if isinstance(circuit.node(nid),
                                  (InputCompare, SignStep))
                  else signed_width(b))
            for nid, b in bounds.items()}
    compare = adder = mult = argmax = 0
    cmp_cost = math.ceil(8 / LUT_INPUTS) + 1
    for n in circuit.nodes:
        if isinstance(n, InputCompare):
            compare += cmp_cost
        elif isinstance(n, WeightedSum):
            # a zero-weight term still occupies one adder slot (see doc)
            in_bits = sum(
                max(abs(t.weight), 1) * width[t.src] for t in n.terms)
            adder += max(in_bits - width[n.id], 0)
            for t in n.terms:
                if abs(t.weight) > 1:
                    mult += width[t.src] * math.ceil(
                        math.log2(abs(t.weight) + 1))
        elif isinstance(n, Argmax):
            w = max((width[s] for s in n.srcs), default=1)
            idx = max(math.ceil(math.log2(max(len(n.srcs), 2))), 1)
            argmax += max(len(n.srcs) - 1, 0) * (w + idx)
    return CellCounts(compare_cells=compare, adder_cells=adder,
                      mult_cells=mult, argmax_cells=argmax)


@dataclasses.dataclass(frozen=True)
class CostReport:
    """The cost target's artifact: the final circuit's cell estimate, the
    per-pass trajectory (when compiled through a pipeline), and the
    paper's Figure-7 reference counts for side-by-side reading."""
    final: CellCounts
    per_pass: tuple = ()        # ((stage_name, CellCounts), ...)
    paper_fig7: tuple = tuple(sorted(PAPER_FIG7_CELLS.items()))

    def as_dict(self) -> dict:
        return {
            "final": self.final.as_dict(),
            "per_pass": [[name, c.as_dict()] for name, c in self.per_pass],
            "paper_fig7": dict(self.paper_fig7),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CostReport":
        mk = lambda c: CellCounts(**{  # noqa: E731
            k: v for k, v in c.items() if k != "total"})
        return cls(
            final=mk(d["final"]),
            per_pass=tuple((name, mk(c)) for name, c in d["per_pass"]),
            paper_fig7=tuple(sorted(d["paper_fig7"].items())))

    def report(self) -> str:
        lines = [f"{name}: {c.row()}" for name, c in self.per_pass]
        lines.append(f"final: {self.final.row()}")
        lines.append("paper fig7: " + ", ".join(
            f"{k}~{v}" for k, v in self.paper_fig7))
        return "\n".join(lines)


def compile_cost(circuit: Circuit, *, _pass_trace=None,
                 _analysis=None) -> CostReport:
    """The `cost` target entry point. `_pass_trace`, supplied by the
    Session driver, is the ((stage_name, circuit), ...) sequence of
    pipeline boundaries — each is priced so the report shows which pass
    bought which cells, the paper's Figure-7 story per rewrite.
    `_analysis` is the driver's range analysis of the FINAL circuit;
    intermediate trace circuits differ structurally, so they are priced
    with freshly derived widths."""
    per_pass = tuple(
        (name, logic_cells(c)) for name, c in (_pass_trace or ()))
    return CostReport(final=logic_cells(circuit, analysis=_analysis),
                      per_pass=per_pass)
