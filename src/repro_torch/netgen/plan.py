"""ExecutionPlan: the one circuit→tensor lowering shared by array backends.

Counterpart of `repro/netgen/plan.py`, producing identical arrays.
`lower_circuit` turns an optimized *regular* circuit into an explicit
layer-structured tensor program — per-layer
weight matrices, the activation applied after each accumulation, the
input binarization threshold, and the final argmax — that backends
execute without ever looking at IR nodes again.

The plan has four orthogonal forms:

  dense    — per-layer int32 (fan_in, fan_out) matrices, activations as
             int8 {0,1} vectors. What the paper's arithmetic literally
             says; the `torch` oracle executes this form.
  packed   — `plan.pack()`: every layer's fan_in axis is zero-padded up
             to a multiple of 32 so the ±1-weighted single-bit
             activations can travel as uint32 words (32 per lane) — the
             analogue of the paper's single-bit wires, 8x less
             activation traffic than int8. Zero-padding is exact: a
             padded activation bit is 0 and its weight row is zero.
  planes   — `plan.planes()`: the packed form with each layer's int32
             weight matrix additionally decomposed into signed binary
             bit-planes, w = sum_b 2^b (pos_plane_b - neg_plane_b),
             every plane packed 32-lanes-per-uint32 along fan_in
             (`decompose_planes`). The plane count is set by the
             layer's ACTUAL post-pass weight magnitude range (tiny for
             the paper's quantized nets), so both operands of
             `binary_matmul_planes` travel as bits — the paper's
             selected-addends idea taken to its packed conclusion: a
             P-plane layer moves 2P bits of weight per addend instead
             of 32, and the kernel accumulates via popcount over words.
  stacked  — `stack_plans([...])`: M compatible single-net plans joined
             along a leading model axis ((M, fan_in, fan_out) weights)
             for the serving layer's multi-net dispatch. Hidden widths
             may differ between versions (pruning is per-model): they
             are zero-padded to the per-layer maximum, exact under the
             strict step semantics (an all-zero column is an empty
             accumulator, step(0) = 0, and its outgoing row is
             zero-padded too). A stacked plan can then be packed or
             plane-decomposed (the plane count is the per-layer maximum
             over the stacked versions).

Backends declare which form they execute via target options
(`cuda`, `cuda[packed=true]`, `cuda[planes=true]`); the Session records the
compiled form on the `Artifact` (`artifact.plan_form`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.netgen.graph import Circuit, as_layered_weights

__all__ = [
    "ExecutionPlan", "MegakernelView", "PlanLayer", "PACK_LANES",
    "decompose_planes", "lower_circuit", "stack_plans",
]

PACK_LANES = 32      # activations per uint32 word in the packed datapath

# Activation kinds a layer can apply to its accumulator vector.
STEP = "step"        # hidden layers: strict sign step, acc > 0 -> {0,1}
ARGMAX = "argmax"    # final layer: the class scores feed the argmax


@dataclasses.dataclass(frozen=True, eq=False)
class PlanLayer:
    """One dense layer of the tensor program.

    `weights` is int32 (fan_in, fan_out) — or (M, fan_in, fan_out) in a
    stacked plan. `activation` says what happens to the accumulator:
    "step" (hidden layers) or "argmax" (the final scores). In a packed
    plan the fan_in axis is padded to a PACK_LANES multiple and `words`
    holds the uint32 lane count (fan_in // 32); dense layers have
    `words` None. In the bit-plane form `pos_planes`/`neg_planes` hold
    the packed uint32 signed bit-planes ((P, words, fan_out), model
    axis leading when stacked) and `n_planes` the plane count P —
    `weights` stays populated as the decomposition's ground truth.
    """
    weights: np.ndarray
    activation: str
    words: int | None = None
    pos_planes: np.ndarray | None = None
    neg_planes: np.ndarray | None = None
    n_planes: int | None = None

    @property
    def fan_in(self) -> int:
        return self.weights.shape[-2]

    @property
    def fan_out(self) -> int:
        return self.weights.shape[-1]


@dataclasses.dataclass(frozen=True, eq=False)
class ExecutionPlan:
    """A complete layer-structured tensor program for one (or M stacked)
    circuit(s): binarize uint8 inputs against `input_threshold`, run the
    layers in order, return the final layer's argmax. See module doc for
    the dense/packed/stacked forms."""
    n_inputs: int
    input_threshold: int
    layers: tuple[PlanLayer, ...]
    packed: bool = False
    bitplanes: bool = False          # packed + plane-decomposed weights
    n_models: int | None = None      # None: single net; M: stacked plans

    @property
    def depth(self) -> int:
        return len(self.layers)

    @property
    def stacked(self) -> bool:
        return self.n_models is not None

    @property
    def form(self) -> str:
        """The datapath form an executor of this plan implements —
        recorded on Artifacts and shown in benchmarks."""
        if self.bitplanes:
            return "planes"
        return "packed" if self.packed else "dense"

    @property
    def n_classes(self) -> int:
        return self.layers[-1].fan_out

    def verify(self, *, collect: bool = False):
        """Certify the plan's invariants via `analysis.verify_plan`:
        layer chain shape agreement, packed lane-padding exactness
        (padding rows all zero), bit-plane decomposition losslessness,
        int32 kernel-accumulation safety at the actual fan-in. Raises
        `analysis.VerificationError` on a violation; `collect=True`
        returns the diagnostics instead."""
        from repro_torch.netgen.analysis import verify_plan
        return verify_plan(self, collect=collect)

    # -- form conversions ----------------------------------------------------

    def pack(self) -> "ExecutionPlan":
        """The packed form of this plan: every layer's fan_in axis
        zero-padded to a PACK_LANES multiple so activations travel as
        uint32 words (see module doc; exact by construction)."""
        if self.packed:
            return self
        layers = []
        for layer in self.layers:
            k = layer.fan_in
            kp = -(-k // PACK_LANES) * PACK_LANES if k else 0
            w = layer.weights
            if kp != k:
                pad = [(0, 0)] * w.ndim
                pad[-2] = (0, kp - k)
                w = np.pad(w, pad)
            layers.append(dataclasses.replace(
                layer, weights=w, words=kp // PACK_LANES))
        return dataclasses.replace(
            self, layers=tuple(layers), packed=True)

    def planes(self) -> "ExecutionPlan":
        """The fully bit-packed form: the packed plan with every layer's
        weight matrix decomposed into packed signed bit-planes (see
        module doc; exact — `decompose_planes` reconstructs the int32
        matrix bit for bit). The plane count is per layer, from that
        layer's actual post-pass weight magnitude range."""
        if self.bitplanes:
            return self
        base = self.pack()
        layers = []
        for layer in base.layers:
            pos, neg, n_planes = decompose_planes(layer.weights)
            layers.append(dataclasses.replace(
                layer, pos_planes=pos, neg_planes=neg, n_planes=n_planes))
        return dataclasses.replace(
            base, layers=tuple(layers), bitplanes=True)

    def megakernel_view(self) -> "MegakernelView":
        """The whole-net megakernel's flattened view of this plan: the
        planes form with each hidden layer's fan_out zero-padded up to
        the NEXT layer's word width (N_l == W_{l+1} * 32), so the
        in-kernel step+repack between layers is a pure reshape with no
        bit shuffling. Zero-width layers are padded to one zero word.
        Padding is exact under strict-step semantics: a padded
        accumulator column is 0, step(0) = 0, and the padded bit lands
        in a zero-padded weight word of the next layer (zero popcount).
        The final layer's fan_out is NOT padded — `n_classes` bounds
        the fused argmax so a phantom class can never win."""
        plan = self.planes()
        if plan.n_classes < 1:
            raise ValueError("megakernel_view needs at least one class")
        depth = plan.depth
        arrays: list[np.ndarray] = []
        layer_words, layer_planes, layer_fan_out = [], [], []
        want_w: int | None = None
        for i, layer in enumerate(plan.layers):
            hidden = i < depth - 1
            w_target = max(1, layer.words) if want_w is None else want_w
            n = layer.fan_out
            n_target = (max(1, -(-n // PACK_LANES)) * PACK_LANES
                        if hidden else n)

            def _padded(a: np.ndarray) -> np.ndarray:
                pw = w_target - a.shape[-2]
                pn = n_target - a.shape[-1]
                if pw or pn:
                    pad = [(0, 0)] * a.ndim
                    pad[-2], pad[-1] = (0, pw), (0, pn)
                    a = np.pad(a, pad)
                return np.ascontiguousarray(a)

            arrays += [_padded(layer.pos_planes), _padded(layer.neg_planes)]
            layer_words.append(w_target)
            layer_planes.append(int(layer.n_planes))
            layer_fan_out.append(n)
            want_w = n_target // PACK_LANES if hidden else None
        return MegakernelView(
            n_inputs=plan.n_inputs,
            input_threshold=plan.input_threshold,
            n_classes=plan.n_classes,
            n_models=plan.n_models,
            layer_words=tuple(layer_words),
            layer_planes=tuple(layer_planes),
            layer_fan_out=tuple(layer_fan_out),
            arrays=tuple(arrays))


@dataclasses.dataclass(frozen=True, eq=False)
class MegakernelView:
    """Shape-generic metadata + flat plane arrays for the whole-net
    megakernel (`repro_torch.kernels.binary_matvec.ops.binary_forward_planes`): per-layer
    word widths / plane counts / TRUE (unpadded) fan_outs, and the
    interleaved (pos_0, neg_0, pos_1, neg_1, ...) uint32 plane arrays —
    (P_l, W_l, N_l) each, leading model axis when stacked — already
    padded so consecutive layers chain by construction."""
    n_inputs: int
    input_threshold: int
    n_classes: int
    n_models: int | None
    layer_words: tuple[int, ...]
    layer_planes: tuple[int, ...]
    layer_fan_out: tuple[int, ...]
    arrays: tuple[np.ndarray, ...]

    @property
    def depth(self) -> int:
        return len(self.layer_words)

    @property
    def stacked(self) -> bool:
        return self.n_models is not None


def decompose_planes(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Decompose an int32 weight matrix (..., K, N) with K a PACK_LANES
    multiple into packed signed bit-planes:

        w = sum_b 2^b (unpack(pos[..., b, :, :]) - unpack(neg[..., b, :, :]))

    Returns (pos, neg, n_planes): uint32 arrays of shape
    (..., P, K // 32, N) — bit i of word j along the packed axis holds
    plane bit (32*j + i) — and P = bit_length(max |w|) (>= 1, so an
    all-zero layer still has a well-formed single zero plane). Positive
    and negative magnitudes get separate planes; a weight is never in
    both."""
    k, n = w.shape[-2], w.shape[-1]
    if k % PACK_LANES:
        raise ValueError(
            f"fan_in {k} is not a multiple of {PACK_LANES}; pack() first")
    mag = np.abs(w)
    n_planes = max(1, int(mag.max(initial=0)).bit_length())
    lead = w.shape[:-2]
    words = k // PACK_LANES
    shifts = np.arange(PACK_LANES, dtype=np.uint32)

    def pack_mag(m: np.ndarray) -> np.ndarray:
        planes = []
        for b in range(n_planes):
            bits = ((m >> np.uint32(b)) & np.uint32(1))
            r = bits.reshape(*lead, words, PACK_LANES, n)
            planes.append(np.bitwise_or.reduce(
                r << shifts[:, None], axis=-2))
        return np.stack(planes, axis=-3)          # (..., P, words, N)

    pos = pack_mag(np.maximum(w, 0).astype(np.uint32))
    neg = pack_mag(np.maximum(-w, 0).astype(np.uint32))
    return pos, neg, n_planes


_FORMS = ("dense", "packed", "planes")


def lower_circuit(circuit: Circuit, *, packed: bool = False,
                  form: str | None = None) -> ExecutionPlan:
    """Lower a *regular* optimized circuit into an ExecutionPlan — the
    single weight-extraction step every array backend compiles through.
    `form` picks the datapath ("dense" / "packed" / "planes"; the
    legacy `packed=True` flag means form="packed"). Raises
    IrregularCircuitError for shared/CSE circuits (which have no
    layered tensor form; see `graph.as_layered_weights`)."""
    if form is None:
        form = "packed" if packed else "dense"
    if form not in _FORMS:
        raise ValueError(f"unknown plan form {form!r} (have {_FORMS})")
    mats = as_layered_weights(circuit)
    layers = tuple(
        PlanLayer(weights=np.asarray(w, dtype=np.int32),
                  activation=STEP if i < len(mats) - 1 else ARGMAX)
        for i, w in enumerate(mats))
    plan = ExecutionPlan(
        n_inputs=circuit.n_inputs,
        input_threshold=circuit.input_threshold,
        layers=layers)
    if form == "packed":
        return plan.pack()
    if form == "planes":
        return plan.planes()
    return plan


def stack_plans(plans: Sequence[ExecutionPlan]) -> ExecutionPlan:
    """Join M compatible single-net dense plans along a leading model
    axis for the multi-net dispatch. Versions must agree on depth, input
    width, class count, and input threshold; hidden widths are
    zero-padded to the per-layer maximum (exact — see module doc).
    Pack *after* stacking (`stack_plans(plans).pack()`): padding hidden
    widths changes the lane count."""
    if not plans:
        raise ValueError("no plans to stack")
    if any(p.packed or p.stacked for p in plans):
        raise ValueError(
            "stack_plans takes dense single-net plans; pack after stacking")

    depths = {p.depth for p in plans}
    if len(depths) != 1:
        raise ValueError(f"versions disagree on depth: {sorted(depths)}")
    thrs = {p.input_threshold for p in plans}
    if len(thrs) != 1:
        raise ValueError(
            f"versions disagree on input threshold: {sorted(thrs)}")
    n_ins = {p.n_inputs for p in plans}
    if len(n_ins) != 1:
        raise ValueError(
            f"versions disagree on input width: {sorted(n_ins)}")
    n_outs = {p.n_classes for p in plans}
    if len(n_outs) != 1:
        # class counts cannot be padded: an extra constant-0 class could
        # win the argmax when every real score is negative
        raise ValueError(
            f"versions disagree on class count: {sorted(n_outs)}")

    depth = depths.pop()
    mats = [[l.weights for l in p.layers] for p in plans]
    for layer in range(depth - 1):
        width = max(m[layer].shape[1] for m in mats)
        for m in mats:
            have = m[layer].shape[1]
            if have < width:
                m[layer] = np.pad(m[layer], ((0, 0), (0, width - have)))
                m[layer + 1] = np.pad(
                    m[layer + 1], ((0, width - have), (0, 0)))
    layers = tuple(
        PlanLayer(
            weights=np.stack([m[layer] for m in mats]).astype(np.int32),
            activation=STEP if layer < depth - 1 else ARGMAX)
        for layer in range(depth))
    return ExecutionPlan(
        n_inputs=n_ins.pop(),
        input_threshold=thrs.pop(),
        layers=layers,
        n_models=len(plans))
