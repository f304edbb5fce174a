"""Frontend: lower a quantized feed-forward stack into the circuit IR.

Accepts any of:
  * a `repro_torch.core.quantize.QuantizedNet` (or the JAX package's) (any depth — the class holds a
    tuple of integer weight matrices),
  * any object with `.weights` (sequence of 2-D int arrays) and
    `.input_threshold`,
  * a bare sequence of 2-D integer arrays (threshold passed separately).

Lowering mirrors the paper's network shape (Fig. 6) generalized to N
layers: one InputCompare per input component, then per dense layer one
WeightedSum per unit, with a SignStep after every layer except the last,
and a single Argmax over the last layer's accumulators. No optimization
happens here — zero weights become zero-weight terms, dead units become
empty consumers — so the pass pipeline's statistics see the true dense
cost. Run `repro_torch.netgen.passes` to optimize. Counterpart of
`repro/netgen/frontend.py`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.netgen.graph import (
    Argmax, Circuit, InputCompare, SignStep, Term, WeightedSum,
)

DEFAULT_INPUT_THRESHOLD = 128  # paper §III.B pixel cutoff


def _validate_threshold(thr) -> int:
    """The pixel threshold must be an integer inside the uint8 domain
    where `pixel > threshold` is a real comparator: thr >= 255 can never
    fire and thr < 0 always fires, so every InputCompare lowered from
    such a value would be a silent constant — reject loudly instead.
    """
    if isinstance(thr, bool) or not isinstance(
            thr, (int, np.integer)):
        raise TypeError(
            f"input_threshold must be an integer, got {thr!r} "
            f"({type(thr).__name__}); pixels are compared as raw uint8")
    thr = int(thr)
    if not 0 <= thr < 255:
        raise ValueError(
            f"input_threshold {thr} is outside the uint8 comparator "
            "domain [0, 255): `pixel > 255` can never fire and a negative "
            "threshold always fires, so the lowered InputCompare would be "
            "a constant (the paper's cutoff is 128)")
    return thr


def _extract_weights(net, input_threshold):
    if hasattr(net, "weights"):
        ws = [np.asarray(w) for w in net.weights]
    elif hasattr(net, "w1") and hasattr(net, "w2"):
        ws = [np.asarray(net.w1), np.asarray(net.w2)]
    else:
        ws = [np.asarray(w) for w in net]
    # explicit caller threshold wins over the net's attribute
    thr = input_threshold
    if thr is None:
        thr = getattr(net, "input_threshold", None)
    if thr is None:
        thr = DEFAULT_INPUT_THRESHOLD
    thr = _validate_threshold(thr)
    if not ws:
        raise ValueError("no weight matrices to lower")
    for w in ws:
        if w.ndim != 2:
            raise ValueError(f"weights must be 2-D, got {w.shape}")
        if not np.issubdtype(w.dtype, np.integer):
            raise ValueError(
                f"netgen lowers *quantized* nets; got dtype {w.dtype} "
                "(run repro_torch.core.quantize first)")
    for a, b in zip(ws, ws[1:]):
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"layer shape mismatch: {a.shape} -> {b.shape}")
    return ws, int(thr)


def lower(net, *, input_threshold: int | None = None) -> Circuit:
    """Lower a quantized N-layer stack into a Circuit. See module doc."""
    ws, thr = _extract_weights(net, input_threshold)
    n_in = ws[0].shape[0]

    nodes: list = []
    nid = 0

    def fresh() -> int:
        nonlocal nid
        nid += 1
        return nid - 1

    acts: list[int] = []  # node ids of the current activation vector
    for i in range(n_in):
        node = InputCompare(id=fresh(), pixel=i, threshold=thr)
        nodes.append(node)
        acts.append(node.id)

    depth = len(ws)
    for layer, w in enumerate(ws, start=1):
        sums: list[int] = []
        for j in range(w.shape[1]):
            terms = tuple(
                Term(weight=int(w[i, j]), src=acts[i]) for i in range(w.shape[0]))
            node = WeightedSum(id=fresh(), terms=terms, layer=layer)
            nodes.append(node)
            sums.append(node.id)
        if layer < depth:
            steps: list[int] = []
            for s in sums:
                node = SignStep(id=fresh(), src=s)
                nodes.append(node)
                steps.append(node.id)
            acts = steps
        else:
            acts = sums

    out = Argmax(id=fresh(), srcs=tuple(acts))
    nodes.append(out)
    circuit = Circuit(
        n_inputs=n_in, input_threshold=thr, nodes=tuple(nodes), output=out.id)
    circuit.validate()
    return circuit
