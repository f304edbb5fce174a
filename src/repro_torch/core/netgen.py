"""netgen — compatibility shim over the `repro_torch.netgen` compiler.

Counterpart of `repro/core/netgen.py`: the original entry points, for
nets of any depth, routed through the compiler:

  * `emit_verilog`  — the faithful artifact: paper Figure-6 style module,
    byte-identical to the reference's for the 2-layer paper net (host
    only; needs no device).
  * `specialize`    — the card's artifact: the predictor of the `torch`
    or `cuda` target after the exact pruning passes, through the
    package's default Session (on the card; raises without CUDA).
  * `prune`/`stats` — the old flat resource model, computed by running
    the IR passes (use `repro_torch.netgen.run_pipeline` for per-pass
    stats).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import netgen as _ng
from repro_torch.core.quantize import QuantizedNet


# ---------------------------------------------------------------------------
# L4: structural pruning (exact rewrites only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PruneInfo:
    n_hidden_before: int
    n_hidden_after: int
    dead_inputs: int            # input pixels ignored by every hidden node
    zero_w1: int                # zeros left inside the first weight matrix
    zero_w2: int                # zeros left inside the last weight matrix

    @property
    def hidden_removed(self) -> int:
        return self.n_hidden_before - self.n_hidden_after

def _n_hidden(circuit: _ng.Circuit) -> int:
    depth = circuit.depth
    return sum(1 for n in circuit.by_kind(_ng.WeightedSum) if n.layer < depth)


def prune(net: QuantizedNet) -> tuple[QuantizedNet, PruneInfo]:
    """Remove structurally dead hidden units (any depth). Exact rewrite:
    a unit with no nonzero input weights is constant 0 and vanishes
    downstream; a unit with no nonzero output weights is never read.
    Per-entry zeros inside surviving rows/cols stay as zeros in the dense
    arrays (the generated programs skip them term by term)."""
    circuit = _ng.lower(net)
    before = _n_hidden(circuit)
    circuit, _ = _ng.run_pipeline(circuit, _ng.DEFAULT_PASSES)
    ws = _ng.as_layered_weights(circuit)
    info = PruneInfo(
        n_hidden_before=before,
        n_hidden_after=_n_hidden(circuit),
        dead_inputs=int(np.sum(np.all(ws[0] == 0, axis=1))),
        zero_w1=int(np.sum(ws[0] == 0)),
        zero_w2=int(np.sum(ws[-1] == 0)),
    )
    pruned = QuantizedNet(weights=ws, input_threshold=circuit.input_threshold)
    return pruned, info


# ---------------------------------------------------------------------------
# Resource model (the paper's logic-cell counting, in arithmetic-op units)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetgenStats:
    """Flat op counts for one generated network, per prediction. The
    pass-pipeline successor is `repro_torch.netgen.PassStats` (per-pass)."""
    mults_dense: int        # naive: one multiply per weight
    adds_dense: int
    mults_pruned: int       # after zero-weight deletion (still multiplying)
    adds_pruned: int
    mults_addend: int       # after the multiplication-free rewrite (== 0)
    adds_addend: int        # one add per |w| unit: sum(|w|) over nonzeros
    zero_fraction: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def stats(net: QuantizedNet) -> NetgenStats:
    circuit = _ng.lower(net)
    dense = _ng.ops(circuit)
    nz = _ng.ops(_ng.delete_zero_terms(circuit))
    return NetgenStats(
        mults_dense=dense.terms,
        adds_dense=dense.terms,          # accumulator adds
        mults_pruned=nz.terms,
        adds_pruned=nz.terms,
        mults_addend=0,                  # the point of L5
        adds_addend=nz.addend_units,
        zero_fraction=1.0 - nz.terms / dense.terms,
    )


# ---------------------------------------------------------------------------
# Faithful artifact: Verilog emission (paper Figures 6/7)
# ---------------------------------------------------------------------------

def emit_verilog(net: QuantizedNet, *, addend: bool = True,
                 module_name: str = "nn_inference") -> str:
    """Emit a clockless combinational Verilog module for the whole net.

    For 2-layer nets this reproduces the paper's Figure 6 byte-for-byte
    (wires, comparator assigns, weight sums, MSB step, priority-mux
    argmax); deeper or CSE-rewritten nets use the generic style of
    `repro_torch.netgen.backends.verilog`.
    """
    return _ng.emit_verilog(net, addend=addend, module_name=module_name)


# ---------------------------------------------------------------------------
# The card's artifact: specialized inference function
# ---------------------------------------------------------------------------

def specialize(net: QuantizedNet, *, backend: str = "torch"):
    """Generate the specialized inference function for a frozen net,
    after the exact pruning passes, on the default device.

    backend: "torch" (the dense oracle) or "cuda" (the per-layer kernel
             chain); any target string of `repro_torch.netgen` works.
    """
    return _ng.specialize(net, backend=backend)
