"""Typed circuit IR for the netgen compiler.

Counterpart of `repro/netgen/graph.py`: the node types, `Circuit` with
its inline `validate`, bit-width inference, `as_layered_weights` (which
the array backends lower through), the array codec, and the reference
interpreter `evaluate`. The paper's network becomes

  InputCompare  — paper §III.B / Fig. 6 line 5: `pixel > threshold` -> 1 bit
  WeightedSum   — a signed accumulator node: sum of weighted single-bit
                  sources. The paper's `hi`/`fi` wires.
  SignStep      — paper §III.A + §V.D: the step activation.
  Argmax        — paper Fig. 6 line 15: the predicted class index.

Nodes are immutable and identified by dense integer ids; a `Circuit` is
a topologically-ordered tuple of nodes. Every value-carrying node has a
signed bit-width inferred exactly from the maximum magnitude it can
reach (`value_bounds` / `signed_width`), which sizes the Verilog wires.

`evaluate` is the reference interpreter, in numpy: the semantic arbiter
of every circuit, including the irregular (CSE-shared) DAGs that no
array backend can run. The compiled backends compute the strict step
`acc > 0`; the emitted Verilog's MSB trick `~acc[msb]` fires on
`acc >= 0`. The two differ only when an accumulator is exactly zero, and
`evaluate(..., step_semantics=...)` exposes both.
"""
from __future__ import annotations

import dataclasses
import math
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

    def consumers(self) -> dict[NodeId, list[NodeId]]:
        """Map node id -> ids of nodes that read it."""
        out: dict[NodeId, list[NodeId]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            if isinstance(n, WeightedSum):
                for t in n.terms:
                    out[t.src].append(n.id)
            elif isinstance(n, SignStep):
                out[n.src].append(n.id)
            elif isinstance(n, Argmax):
                for s in n.srcs:
                    out[s].append(n.id)
        return out

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
# Bit-width inference
# ---------------------------------------------------------------------------

def value_bounds(circuit: Circuit) -> dict[NodeId, int]:
    """Exact per-node bound on |value|: single-bit nodes are 1; a sum node
    reaches at most `sum(|w| * bound(src))`. One topological sweep."""
    bound: dict[NodeId, int] = {}
    for n in circuit.nodes:
        if isinstance(n, (InputCompare, SignStep)):
            bound[n.id] = 1
        elif isinstance(n, WeightedSum):
            bound[n.id] = sum(abs(t.weight) * bound[t.src] for t in n.terms)
        elif isinstance(n, Argmax):
            bound[n.id] = max(len(n.srcs) - 1, 1)
    return bound


def signed_width(bound: int) -> int:
    """Bits for a signed register holding values in [-bound, bound]."""
    return max(math.ceil(math.log2(bound + 1)) + 1, 2) if bound > 0 else 2


def node_widths(circuit: Circuit) -> dict[NodeId, int]:
    """Per-node signed bit-widths (1 for the single-bit node kinds)."""
    widths: dict[NodeId, int] = {}
    for nid, b in value_bounds(circuit).items():
        n = circuit.node(nid)
        if isinstance(n, (InputCompare, SignStep)):
            widths[nid] = 1
        elif isinstance(n, Argmax):
            widths[nid] = max(math.ceil(math.log2(max(len(n.srcs), 2))), 1)
        else:
            widths[nid] = signed_width(b)
    return widths


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


# ---------------------------------------------------------------------------
# Array codec (the persistent form of a circuit)
# ---------------------------------------------------------------------------

_KIND_CODES = {InputCompare: 0, WeightedSum: 1, SignStep: 2, Argmax: 3}


def circuit_to_arrays(circuit: Circuit) -> dict[str, np.ndarray]:
    """Encode a circuit (regular OR irregular DAG) as a flat dict of
    integer arrays, the form the reference's `ArtifactStore` persists via
    `np.savez` (the same keys and dtypes). Compact (terms are one (host_row, weight,
    src) int64 triple each, not a Python object) and code-free (no
    pickle: the store stays loadable across refactors and trustworthy
    across processes). `circuit_from_arrays` is the exact inverse.
    """
    kinds, ids = [], []
    cmp_pixel, cmp_thr = [], []
    sum_layer, sum_nterms, term_weight, term_src = [], [], [], []
    step_src, argmax_srcs, argmax_nsrcs = [], [], []
    for n in circuit.nodes:
        kinds.append(_KIND_CODES[type(n)])
        ids.append(n.id)
        if isinstance(n, InputCompare):
            cmp_pixel.append(n.pixel)
            cmp_thr.append(n.threshold)
        elif isinstance(n, WeightedSum):
            sum_layer.append(n.layer)
            sum_nterms.append(len(n.terms))
            for t in n.terms:
                term_weight.append(t.weight)
                term_src.append(t.src)
        elif isinstance(n, SignStep):
            step_src.append(n.src)
        else:
            argmax_nsrcs.append(len(n.srcs))
            argmax_srcs.extend(n.srcs)
    i64 = lambda xs: np.asarray(xs, dtype=np.int64)  # noqa: E731
    return {
        "header": i64([circuit.n_inputs, circuit.input_threshold,
                       circuit.output]),
        "kinds": i64(kinds), "ids": i64(ids),
        "cmp_pixel": i64(cmp_pixel), "cmp_thr": i64(cmp_thr),
        "sum_layer": i64(sum_layer), "sum_nterms": i64(sum_nterms),
        "term_weight": i64(term_weight), "term_src": i64(term_src),
        "step_src": i64(step_src),
        "argmax_nsrcs": i64(argmax_nsrcs), "argmax_srcs": i64(argmax_srcs),
    }


def circuit_from_arrays(arrays) -> Circuit:
    """Rebuild a circuit from `circuit_to_arrays` output (or an opened
    `np.load` of it). Validates the result before returning it."""
    a = {k: np.asarray(arrays[k]) for k in (
        "header", "kinds", "ids", "cmp_pixel", "cmp_thr", "sum_layer",
        "sum_nterms", "term_weight", "term_src", "step_src",
        "argmax_nsrcs", "argmax_srcs")}
    n_inputs, input_threshold, output = (int(v) for v in a["header"])
    nodes: list[Node] = []
    ci = si = ti = pi = ai = aj = 0
    for kind, nid in zip(a["kinds"].tolist(), a["ids"].tolist()):
        if kind == 0:
            nodes.append(InputCompare(
                id=nid, pixel=int(a["cmp_pixel"][ci]),
                threshold=int(a["cmp_thr"][ci])))
            ci += 1
        elif kind == 1:
            k = int(a["sum_nterms"][si])
            terms = tuple(
                Term(weight=int(a["term_weight"][ti + j]),
                     src=int(a["term_src"][ti + j])) for j in range(k))
            nodes.append(WeightedSum(
                id=nid, terms=terms, layer=int(a["sum_layer"][si])))
            si += 1
            ti += k
        elif kind == 2:
            nodes.append(SignStep(id=nid, src=int(a["step_src"][pi])))
            pi += 1
        elif kind == 3:
            k = int(a["argmax_nsrcs"][ai])
            nodes.append(Argmax(id=nid, srcs=tuple(
                int(s) for s in a["argmax_srcs"][aj:aj + k])))
            ai += 1
            aj += k
        else:
            raise ValueError(f"unknown node kind code {kind}")
    circuit = Circuit(n_inputs=n_inputs, input_threshold=input_threshold,
                      nodes=tuple(nodes), output=output)
    circuit.validate()
    return circuit


# ---------------------------------------------------------------------------
# Reference interpreter (the semantic arbiter for every backend)
# ---------------------------------------------------------------------------

def evaluate(
    circuit: Circuit,
    x_uint8: np.ndarray,
    *,
    step_semantics: str = "strict",
    check_widths: bool = False,
) -> np.ndarray:
    """Execute the circuit on a batch of uint8 inputs (B, n_inputs).

    step_semantics: "strict" — step fires on `acc > 0` (the arithmetic the
    compiled array backends and `quantize.predict_quantized` implement);
    "msb" — step is `~acc[msb]`, i.e. fires on `acc >= 0` (the emitted
    Verilog's §V.D MSB trick). check_widths asserts every accumulator
    stays inside its inferred signed bit-width.
    """
    if step_semantics not in ("strict", "msb"):
        raise ValueError(f"unknown step_semantics {step_semantics!r}")
    x = np.asarray(x_uint8)
    if x.ndim != 2 or x.shape[1] != circuit.n_inputs:
        raise ValueError(f"expected (B, {circuit.n_inputs}), got {x.shape}")
    widths = node_widths(circuit) if check_widths else None

    vals: dict[NodeId, np.ndarray] = {}
    out = None
    for n in circuit.nodes:
        if isinstance(n, InputCompare):
            vals[n.id] = (x[:, n.pixel].astype(np.int64) > n.threshold).astype(np.int64)
        elif isinstance(n, WeightedSum):
            acc = np.zeros(x.shape[0], dtype=np.int64)
            for t in n.terms:
                acc += t.weight * vals[t.src]
            if widths is not None:
                lim = 2 ** (widths[n.id] - 1)
                assert np.all(acc >= -lim) and np.all(acc < lim), (
                    f"sum node {n.id} overflows its {widths[n.id]}-bit width")
            vals[n.id] = acc
        elif isinstance(n, SignStep):
            v = vals[n.src]
            vals[n.id] = (v > 0 if step_semantics == "strict" else v >= 0).astype(np.int64)
        elif isinstance(n, Argmax):
            stacked = np.stack([vals[s] for s in n.srcs], axis=1)
            out = vals[n.id] = np.argmax(stacked, axis=1)
    if out is None:
        raise ValueError("circuit has no Argmax output node")
    return vals[circuit.output]
