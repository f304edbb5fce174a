"""Typed circuit IR for the netgen compiler.

Counterpart of `repro/netgen/graph.py`: the node types, `Circuit` with
its inline `validate`, and `as_layered_weights`, which the array
backends lower through. The paper's network becomes

  InputCompare  — paper §III.B / Fig. 6 line 5: `pixel > threshold` -> 1 bit
  WeightedSum   — a signed accumulator node: sum of weighted single-bit
                  sources. The paper's `hi`/`fi` wires.
  SignStep      — paper §III.A + §V.D: the step activation.
  Argmax        — paper Fig. 6 line 15: the predicted class index.

Nodes are immutable and identified by dense integer ids; a `Circuit` is
a topologically-ordered tuple of nodes. Bit-width inference, the array
codec and the reference interpreter are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Union

import numpy as np

NodeId = int


@dataclasses.dataclass(frozen=True)
class Term:
    """One addend of a WeightedSum: `weight * value(src)`."""
    weight: int
    src: NodeId


@dataclasses.dataclass(frozen=True)
class InputCompare:
    """1-bit comparator on one raw input component: `x[pixel] > threshold`."""
    id: NodeId
    pixel: int
    threshold: int


@dataclasses.dataclass(frozen=True)
class WeightedSum:
    """Signed integer accumulator: `sum(t.weight * value(t.src))`.

    `layer` tags which dense layer the node was lowered from (1-based);
    pass-created sharing nodes keep the layer of their consumers. Backends
    that reconstruct dense matrices group by this tag.
    """
    id: NodeId
    terms: tuple[Term, ...]
    layer: int


@dataclasses.dataclass(frozen=True)
class SignStep:
    """Step activation of one accumulator (1 bit)."""
    id: NodeId
    src: NodeId


@dataclasses.dataclass(frozen=True)
class Argmax:
    """Priority argmax over the final accumulators (first max wins)."""
    id: NodeId
    srcs: tuple[NodeId, ...]


Node = Union[InputCompare, WeightedSum, SignStep, Argmax]


class IrregularCircuitError(ValueError):
    """Raised when a backend needs the regular layered form (dense weight
    matrices) but the circuit has been rewritten into a general DAG
    (e.g. by common-addend sharing)."""


@dataclasses.dataclass(frozen=True)
class Circuit:
    """A complete inference circuit: uint8 input vector -> class index.

    `nodes` is topologically ordered (every Term.src / SignStep.src /
    Argmax.src precedes its consumer). `output` is the Argmax node id.
    """
    n_inputs: int
    input_threshold: int
    nodes: tuple[Node, ...]
    output: NodeId

    # -- structure helpers ---------------------------------------------------

    def node(self, nid: NodeId) -> Node:
        return self._by_id()[nid]

    def _by_id(self) -> dict[NodeId, Node]:
        cache = getattr(self, "_id_cache", None)
        if cache is None or len(cache) != len(self.nodes):
            cache = {n.id: n for n in self.nodes}
            object.__setattr__(self, "_id_cache", cache)
        return cache

    def by_kind(self, kind: type) -> list[Node]:
        return [n for n in self.nodes if isinstance(n, kind)]

    @property
    def depth(self) -> int:
        """Number of dense layers the circuit was lowered from."""
        sums = self.by_kind(WeightedSum)
        return max((n.layer for n in sums), default=0)

    def validate(self) -> None:
        """Check topological order, id uniqueness, and output wiring."""
        seen: set[NodeId] = set()
        for n in self.nodes:
            if n.id in seen:
                raise ValueError(f"duplicate node id {n.id}")
            if isinstance(n, WeightedSum):
                srcs: Iterable[NodeId] = (t.src for t in n.terms)
            elif isinstance(n, SignStep):
                srcs = (n.src,)
            elif isinstance(n, Argmax):
                srcs = n.srcs
            else:
                srcs = ()
            for s in srcs:
                if s not in seen:
                    raise ValueError(
                        f"node {n.id} reads {s} before it is defined")
            seen.add(n.id)
        if self.output not in seen or not isinstance(self.node(self.output), Argmax):
            raise ValueError("output must name an Argmax node")


# ---------------------------------------------------------------------------
# Layered-form extraction (for dense backends)
# ---------------------------------------------------------------------------

def as_layered_weights(circuit: Circuit) -> list[np.ndarray]:
    """Reconstruct dense int32 weight matrices from a *regular* circuit.

    Regular means: layer-l sums read only layer-(l-1) activations (inputs
    for l == 1), every hidden sum feeds exactly one SignStep, and the
    Argmax reads exactly the last layer's sums. Addend-rewritten circuits
    are fine (duplicate unit terms re-accumulate); shared/CSE circuits are
    not and raise IrregularCircuitError.
    """
    inputs = circuit.by_kind(InputCompare)
    sums = circuit.by_kind(WeightedSum)
    steps = circuit.by_kind(SignStep)
    depth = circuit.depth
    if depth == 0:
        raise IrregularCircuitError("circuit has no WeightedSum nodes")

    step_of = {s.src: s.id for s in steps}
    by_layer: dict[int, list[WeightedSum]] = {}
    for n in sums:
        by_layer.setdefault(n.layer, []).append(n)

    # activation index of each source node for the next layer up. A layer
    # pruned down to zero units yields a zero-width matrix (downstream
    # layers then sum nothing and score 0 — the constant-0 predictor).
    src_index: dict[NodeId, int] = {
        n.id: i for i, n in enumerate(sorted(inputs, key=lambda n: n.pixel))}
    mats: list[np.ndarray] = []
    for layer in range(1, depth + 1):
        cols = by_layer.get(layer, [])
        w = np.zeros((len(src_index), len(cols)), dtype=np.int32)
        next_index: dict[NodeId, int] = {}
        for j, n in enumerate(cols):
            for t in n.terms:
                if t.src not in src_index:
                    raise IrregularCircuitError(
                        f"layer {layer} sum {n.id} reads non-layer source {t.src}")
                w[src_index[t.src], j] += t.weight
            if layer < depth:
                if n.id not in step_of:
                    raise IrregularCircuitError(
                        f"hidden sum {n.id} has no SignStep")
                next_index[step_of[n.id]] = j
        mats.append(w)
        src_index = next_index
    return mats
