"""cuda backend: execute an ExecutionPlan on the port's CUDA kernels.

Counterpart of `repro/netgen/backends/pallas.py`. The per-layer chain
(any depth) runs one kernel launch per layer with the step at the layer
boundary; the datapath follows the plan form (`cuda`,
`cuda[packed=true]`, `cuda[planes=true]`):

  dense     — activations travel as int8 {0,1} into `binary_matmul`
              (one byte per wire); binarize and step are torch ops
              between the launches.
  packed    — activations are packed 32 to an int32 word end to end:
              binarize emits words, every hidden boundary is a
              `step_pack`, and `binary_matmul_packed` consumes them (one
              bit per wire).

              Both hold int8 weights in the tensor-core kernels' layout
              (`mma_weights`), and so run on the int8 tensor cores, when
              every layer's weights fit int8 (decided once, from the
              plan's host arrays, when the predictor is built); otherwise
              int32 weights and the scalar kernels.
  planes    — both operands travel as bits: weights split into packed
              signed bit-planes, one `binary_matmul_planes` launch per
              layer, `sum_b 2^b (popc(x & pos_b) - popc(x & neg_b))` on
              the 1-bit tensor cores; the planes are held K-contiguous
              per column (`plane_mma_weights`), made once at build.
  fusednet  — the whole planes-form net (any depth whose activations
              fit shared memory, single or stacked) as ONE
              `binary_forward_planes` launch through
              `plan.megakernel_view()`, its layer table built once; on
              the 1-bit tensor cores with the planes held in the
              `plane_mma_weights` layout, or, for a net whose
              activations that route cannot hold, on the scalar kernel
              with the planes row-major (decided once at build).

The stacked multi-net dispatch prefers the megakernel for the bit-plane
options: `planes=true` builds it and falls back to the per-layer chain
when the plan has no view the kernel takes; `fusednet=true` is strict.
Dense and packed sweep the model axis with a Python loop (depth x M
launches per call against the megakernel's 1).

`compile_fused` lowers the paper's 2-layer net into ONE
`fused_mlp_predict` launch over the dense weights (the `fused` target):
int8 weights in the tensor-core layout (`mma_weights`) when both layers
fit int8, decided once at build as for the chains; otherwise int32 and
the scalar kernel.

Predictors take uint8 images (numpy or tensor), return int32 class ids
as a tensor on the compile device, and carry `plan_form`, `datapath`,
`blocks` and `launches_per_call`, plus `weight_bytes` and `ops_per_row`
(the counts `telemetry.jit_cost` reads). Every call adds its launches to
`netgen_kernel_launches_total{form}`: depth for a chain, depth x M for
the looped multi chain, 1 for the megakernel ("fusednet") and for the
2-layer kernel ("fused"). On a CPU device the wrappers run the kernels'
plain versions.

Block shapes (`bm`, `bn`) are declared target options; with
`cuda[tuned=true]` they, and, when no form is forced, the
dense/packed/planes/fusednet choice itself, are grid-searched per
(plan shape x device kind) through `repro_torch.netgen.tune` and
persisted, so a warm process never re-measures (`Session(tune_store=
...)`); `fused[tuned=true]` searches its `bm`. The grid is Hopper's own
(`_TUNE_BLOCKS`: each form's default and shapes every kernel takes),
filtered by `analysis.tile_legality` before any measurement. A
measurement is the reference's: best of `reps` calls on the host clock,
the answers copied to the host so the device has finished. The device
kind in every key is the CUDA device's name and compute capability
(`tune.device_kind`), or "cpu". `cuda[explored=true]` resolves the
design-space explorer's winner for the plan's shape from its
`cuda-explored` record (`publish_explored`), with zero measurements,
and is inert without one. No port kernel blocks K (each walks K whole
or in fixed 32-column stages), so the reference's `bkw` has no
counterpart: `bkw=` raises ValueError.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels.binary_matvec import ops as bmv
from repro_torch.netgen import telemetry
from repro_torch.netgen.backends.torch_ref import as_device_images
from repro_torch.netgen.graph import Circuit, IrregularCircuitError
from repro_torch.netgen.plan import ExecutionPlan, lower_circuit

__all__ = ["compile_cuda", "compile_cuda_multi", "compile_fused",
           "explored_key_fields", "explored_record", "publish_explored"]

# Executable datapaths: the plan forms plus the whole-net megakernel
# (which runs the planes form, but as one launch).
_DATAPATHS = ("dense", "packed", "planes", "fusednet")

# The tuner's candidate grid, Hopper's own: block shapes every kernel
# takes (`bm` in `launch.BLOCK_ROWS`, `bn` a multiple of 32 up to 1,024,
# `check_matmul_blocks`), each form's default among them. The megakernel
# reads only `bm`; on a tensor-core route `bm` maps to a 16- or 32-row
# tile, so `analysis.tile_legality` drops the candidates that launch a
# kernel another one already launches.
_TUNE_BLOCKS = (
    {"bm": bmv.MMA_BM, "bn": bmv.MMA_BN},          # tensor-core and planes default
    {"bm": bmv.DENSE_BM, "bn": bmv.DENSE_BN},      # dense scalar default
    {"bm": bmv.PACKED_BM, "bn": bmv.PACKED_BN},    # packed scalar default; FORWARD_BM
    {"bm": 32, "bn": 128},
)
_TUNE_BATCH = 256        # measurement batch: the serve layer's default cap
_FUSED_TUNE_BM = (2, 4, 8, 16)   # FUSED_BM first; the int8 route takes 16 rows whatever bm


def _refuse_bkw(bkw) -> None:
    if bkw is not None:
        raise ValueError(
            "cuda: bkw has no counterpart on the card: no port kernel blocks "
            "K (each walks K whole or in fixed 32-column stages), a deliberate "
            "difference from the reference's pallas targets")


def _resolve_form(packed: bool, planes: bool, fusednet: bool) -> str | None:
    """The requested datapath, or None when the caller left the choice
    open (tuned=true may then search it; otherwise it means dense).
    `fusednet` runs the planes form, so planes+fusednet means fusednet;
    packed is a different activation encoding and stays exclusive."""
    if packed and (planes or fusednet):
        raise ValueError(
            "cuda: packed=true is exclusive with the bit-plane datapaths "
            "(planes=true / fusednet=true)")
    if fusednet:
        return "fusednet"
    if planes:
        return "planes"
    return "packed" if packed else None


def _in_form(plan: ExecutionPlan, form: str) -> ExecutionPlan:
    if form in ("planes", "fusednet"):
        return plan.planes()
    if form == "packed":
        return plan.pack()
    return plan


def _words(a, device: torch.device) -> torch.Tensor:
    """uint32 plane words (numpy) as an int32 tensor with the same bits."""
    return torch.from_numpy(a.view("int32")).to(device)


def _zeros(a: torch.Tensor, n: int) -> torch.Tensor:
    """The constant-0 accumulator of a layer whose fan_in was fully pruned."""
    return torch.zeros((a.shape[0], n), dtype=torch.int32, device=a.device)


def _argmax(acc: torch.Tensor) -> torch.Tensor:
    return torch.argmax(acc, dim=-1).to(torch.int32)


def _fits_int8(plan: ExecutionPlan) -> bool:
    """Every layer's weights lie in [-128, 127] (an empty layer fits)."""
    return all(l.weights.size == 0 or (-128 <= l.weights.min() and l.weights.max() <= 127)
               for l in plan.layers)


def _chain(plan: ExecutionPlan, blocks: dict, device: torch.device):
    """One version's per-layer chain for the plan's form.

    Returns (arrays, run): `arrays` is a flat tuple of per-layer weight
    tensors (leading model axis when the plan is stacked) and
    `run(x_uint8, *arrays)` maps one version's uint8 batch to int32
    class ids. The packed and planes chains are packed end to end:
    binarize emits words, every hidden boundary is a `step_pack`.
    """
    form = plan.form
    thr = plan.input_threshold

    if form in ("dense", "packed"):
        kernel = bmv.binary_matmul if form == "dense" else bmv.binary_matmul_packed
        bm, bn = blocks.get("bm"), blocks.get("bn")
        bmv.check_matmul_blocks(bm, bn)
        if _fits_int8(plan):
            arrays = tuple(bmv.mma_weights(torch.as_tensor(l.weights, dtype=torch.int8,
                                                           device=device))
                           for l in plan.layers)
        else:
            arrays = tuple(torch.as_tensor(l.weights, dtype=torch.int32, device=device)
                           for l in plan.layers)

        def matmul(a, w):
            if w.shape[-2] == 0:
                return _zeros(a, w.shape[-1])
            return kernel(a, w, bm=bm, bn=bn)

        if form == "dense":
            def run(x_uint8, *ws):
                a = (x_uint8.to(torch.int32) > thr).to(torch.int8)
                for w in ws[:-1]:
                    a = (matmul(a, w) > 0).to(torch.int8)
                return _argmax(matmul(a, ws[-1]))

            return arrays, run

        words = [l.words for l in plan.layers]

        def run(x_uint8, *ws):
            a = bmv.binarize_pack(x_uint8, threshold=thr, words=words[0])
            for w, nxt in zip(ws[:-1], words[1:]):
                a = bmv.step_pack(matmul(a, w), words=nxt)
            return _argmax(matmul(a, ws[-1]))

        return arrays, run

    assert form == "planes", form
    bm, bn = bmv.check_matmul_blocks(blocks.get("bm"), blocks.get("bn"))
    arrays = []
    for layer in plan.layers:
        arrays.append(bmv.plane_mma_weights(_words(layer.pos_planes, device)))
        arrays.append(bmv.plane_mma_weights(_words(layer.neg_planes, device)))
    words = [l.words for l in plan.layers]
    fan_outs = [l.fan_out for l in plan.layers]

    def plane_matmul(a, pos, neg, fan_out):
        if pos.shape[-2] == 0:       # zero words: fully-pruned fan_in
            return _zeros(a, fan_out)
        return bmv.binary_matmul_planes(a, pos, neg, bm=bm, bn=bn)

    def run(x_uint8, *planes):
        a = bmv.binarize_pack(x_uint8, threshold=thr, words=words[0])
        for i in range(len(fan_outs) - 1):
            acc = plane_matmul(a, planes[2 * i], planes[2 * i + 1], fan_outs[i])
            a = bmv.step_pack(acc, words=words[i + 1])
        return _argmax(plane_matmul(a, planes[-2], planes[-1], fan_outs[-1]))

    return tuple(arrays), run


def _finish_predictor(predict, *, plan: ExecutionPlan, arrays, datapath: str,
                      blocks: dict, launches: int):
    """Stamp the attributes callers read: the executed plan form, the
    datapath (the form, "fusednet" for the megakernel, "fused" for the
    2-layer kernel), the chosen blocks, kernel launches per call, and
    what `telemetry.jit_cost` counts: the bytes of the weight arrays the
    predictor holds, and the layers' integer operations per input row of
    one version (a multiply and an add per weight of the plan)."""
    predict.plan_form = plan.form
    predict.datapath = datapath
    predict.blocks = dict(blocks)
    predict.launches_per_call = launches
    predict.weight_bytes = sum(a.numel() * a.element_size() for a in arrays)
    predict.ops_per_row = 2 * sum(l.fan_in * l.fan_out for l in plan.layers)
    return predict


def _build_single(plan: ExecutionPlan, blocks: dict, device: torch.device):
    arrays, run = _chain(plan, blocks, device)
    form, depth = plan.form, plan.depth

    def predict(x_uint8):
        telemetry.kernel_launches(form).inc(depth)
        return run(as_device_images(x_uint8, device), *arrays)

    return _finish_predictor(predict, plan=plan, arrays=arrays, datapath=form,
                             blocks=blocks, launches=depth)


def _build_multi(plan: ExecutionPlan, blocks: dict, device: torch.device):
    arrays, run = _chain(plan, blocks, device)
    n_models = plan.n_models or 1
    form, launches = plan.form, plan.depth * n_models

    def predict(x_uint8):                           # (M, B, n_in)
        telemetry.kernel_launches(form).inc(launches)
        x = as_device_images(x_uint8, device)
        return torch.stack([run(x[m], *[a[m] for a in arrays])
                            for m in range(n_models)])

    return _finish_predictor(predict, plan=plan, arrays=arrays, datapath=form,
                             blocks=blocks, launches=launches)


def _build_fusednet(plan: ExecutionPlan, blocks: dict, device: torch.device):
    """The whole-net megakernel predictor: one `binary_forward_planes`
    launch per call, single (B, n_in) or stacked (M, B, n_in). Raises
    ValueError when the plan has no megakernel view the kernel takes
    (callers that merely prefer the megakernel fall back to the chain)."""
    view = plan.megakernel_view()
    bm = bmv.check_forward_planes(view.layer_words, blocks.get("bm"))
    arrays = tuple(_words(a, device) for a in view.arrays)
    if bmv.forward_on_mma(view.layer_planes, view.layer_words, bm):   # the route's layout, once
        arrays = tuple(bmv.plane_mma_weights(a) for a in arrays)
    table = bmv.ForwardTable(arrays)

    def predict(x_uint8):
        telemetry.kernel_launches("fusednet").inc()
        return bmv.binary_forward_planes(
            as_device_images(x_uint8, device), *arrays,
            threshold=view.input_threshold, n_classes=view.n_classes, bm=bm,
            table=table)

    return _finish_predictor(predict, plan=plan, arrays=arrays, datapath="fusednet",
                             blocks=blocks, launches=1)


# ---------------------------------------------------------------------------
# Autotuning (repro_torch.netgen.tune) and explored records
# ---------------------------------------------------------------------------

def _plan_signature(plan: ExecutionPlan) -> dict:
    """The JSON-stable shape identity tuning records are keyed on: layer
    geometry plus each layer's bit-plane count (the plane count sets the
    planes kernels' work, so nets of equal shape but different weight
    ranges tune separately). Computed from magnitudes directly: no plane
    decomposition is materialized for keying."""
    return {
        "n_inputs": plan.n_inputs,
        "widths": [l.fan_out for l in plan.layers],
        "n_models": plan.n_models,
        "n_planes": [
            max(1, int(np.abs(l.weights).max(initial=0)).bit_length())
            for l in plan.layers],
    }


def _tuner_or_default(tuner):
    from repro_torch.netgen import tune

    return tuner if tuner is not None else tune.default_tuner()


# The design-space explorer publishes its winning datapath (form +
# blocks) under this pseudo-target, keyed on the plan signature alone —
# not on a candidate grid — so any later compile of the same shape can
# resolve it without knowing how the search was configured.
_EXPLORED_TARGET = "cuda-explored"


def explored_key_fields(signature: dict, *, device, multi: bool) -> dict:
    """The JSON-stable identity an explored datapath record is keyed on
    (the reference's `pallas-explored` fields, keyed on the CUDA device's
    name and compute capability instead of a TPU's device kind, with no
    `interpret`). The explorer writes through it and `cuda[explored=true]`
    reads through it."""
    from repro_torch.netgen.tune import device_kind

    return {
        "target": _EXPLORED_TARGET,
        "device_kind": device_kind(device),
        "multi": bool(multi),
        "signature": signature,
    }


def publish_explored(plan: ExecutionPlan, tuner, best: dict, *, device,
                     measurements=(), extra=None):
    """Upsert the explored winner's datapath record for this plan shape
    (`best`: form + bm/bn). Called by `repro_torch.netgen.explore` after
    a search; later `explored=true` compiles of the same signature on a
    device of the same kind resolve it with zero measurements."""
    fields = explored_key_fields(_plan_signature(plan), device=device,
                                 multi=plan.stacked)
    return _tuner_or_default(tuner).publish(
        fields, best, measurements=measurements, extra=extra)


def explored_record(plan: ExecutionPlan, tuner, *, device, multi: bool):
    """The resident explored-winner record for this plan shape, or None.
    A stacked lookup that misses falls back to the single-net signature
    (model axis erased): the explorer searches one net at a time, and a
    homogeneous stack executes the same per-model geometry the single
    net was measured on."""
    from repro_torch.netgen import tune

    tuner = _tuner_or_default(tuner)
    sig = _plan_signature(plan)
    rec = tuner.record_for(tune.tune_key(
        explored_key_fields(sig, device=device, multi=multi)))
    if rec is None and multi:
        rec = tuner.record_for(tune.tune_key(explored_key_fields(
            {**sig, "n_models": None}, device=device, multi=False)))
    return rec


def _form_compatible(pinned: str | None, recorded: str) -> bool:
    """May an explored record's form satisfy an explicitly pinned one?
    planes and fusednet are the same bit-plane datapath family (the
    megakernel runs the planes form), so they satisfy each other; any
    other disagreement means the record is ignored."""
    if pinned is None or pinned == recorded:
        return True
    return {pinned, recorded} == {"planes", "fusednet"}


def _host_seconds(fn, x) -> float:
    """One call's host-clock seconds, its answers copied to the host so
    the device has finished."""
    t0 = time.perf_counter()
    fn(x).cpu()
    return time.perf_counter() - t0


def _tuned_params(plan: ExecutionPlan, blocks: dict, forms, tuner, *,
                  device: torch.device, multi: bool):
    """Grid-search (form x block shape) for this plan through the tuner
    (memory -> store -> measure); returns (winning params, the winner's
    already-built predictor, or None on a warm record hit). Explicit
    block options are pinned, not searched."""
    from repro_torch.netgen.analysis import tile_legality
    from repro_torch.netgen.tune import device_kind

    tuner = _tuner_or_default(tuner)
    pinned = {k: v for k, v in blocks.items() if v is not None}
    candidates = []
    seen = set()
    for form in forms:
        for grid in _TUNE_BLOCKS:
            cand = {"form": form, **grid, **pinned}
            key = tuple(sorted(cand.items()))
            if key not in seen:
                seen.add(key)
                candidates.append(cand)

    batch = _TUNE_BATCH if not multi else max(32, _TUNE_BATCH // 4)
    shape = ((batch, plan.n_inputs) if not multi
             else (plan.n_models, batch, plan.n_inputs))
    x = np.zeros(shape, np.uint8)
    built: dict = {}

    def measure(cand: dict) -> float:
        ckey = tuple(sorted(cand.items()))
        fn = built.get(ckey)
        if fn is None:
            form = cand["form"]
            cblocks = {k: cand[k] for k in ("bm", "bn")}
            if form == "fusednet":
                fn = _build_fusednet(plan.planes(), cblocks, device)
            else:
                build = _build_multi if multi else _build_single
                fn = build(_in_form(plan, form), cblocks, device)
            built[ckey] = fn
        return _host_seconds(fn, x)

    key_fields = {
        "target": "cuda",
        "device_kind": device_kind(device),
        "multi": bool(multi),
        "batch": batch,
        "signature": _plan_signature(plan),
        "candidates": candidates,
    }
    best = tuner.get_or_tune(
        key_fields, candidates, measure,
        legal=tile_legality(plan, batch=batch, multi=multi))
    return best, built.get(tuple(sorted(best.items())))


def _resolve_datapath(plan: ExecutionPlan, *, packed, planes, fusednet,
                      tuned, explored, bm, bn, bkw, tuner,
                      device: torch.device, multi: bool):
    """Turn the declared target options into (form, blocks, prebuilt):
    explicit options pin their axis; `tuned=true` searches the rest
    (over every datapath, megakernel included, when no form is forced).
    `prebuilt` is the winning predictor when this process's search just
    built it (None otherwise — the caller builds).

    `explored=true` consults the design-space explorer's persisted
    winner for this plan signature first: a resident record supplies the
    form and any unpinned block sizes with zero measurements; without
    one (or when it contradicts an explicitly pinned form) the option is
    inert and resolution falls through to tuned/default, so the serving
    layer can request it unconditionally."""
    _refuse_bkw(bkw)
    form = _resolve_form(packed, planes, fusednet)
    blocks = {"bm": bm, "bn": bn}
    if explored:
        rec = explored_record(plan, tuner, device=device, multi=multi)
        hit = rec is not None and _form_compatible(form, rec.best.get("form"))
        telemetry.get_registry().counter(
            "netgen_explored_resolved_total",
            outcome="hit" if hit else "miss").inc()
        if hit:
            best = rec.best
            if form is None:
                form = best["form"]
            return form, {k: blocks[k] if blocks[k] is not None
                          else best.get(k) for k in blocks}, None
    if tuned:
        forms = (form,) if form is not None else _DATAPATHS
        best, prebuilt = _tuned_params(plan, blocks, forms, tuner,
                                       device=device, multi=multi)
        return best["form"], {k: best[k] for k in ("bm", "bn")}, prebuilt
    return form or "dense", blocks, None


# ---------------------------------------------------------------------------
# Target entry points
# ---------------------------------------------------------------------------

def compile_cuda(circuit: Circuit, *, device: torch.device,
                 packed: bool = False, planes: bool = False,
                 fusednet: bool = False, tuned: bool = False,
                 explored: bool = False, bm: int | None = None,
                 bn: int | None = None, bkw: int | None = None, _tuner=None):
    """A predictor chaining one kernel launch per plan layer — dense
    (`binary_matmul`, no option), `packed=true` (`binary_matmul_packed`)
    or `planes=true` (`binary_matmul_planes`) — or ONE whole-net
    `binary_forward_planes` launch (`fusednet=true`). `bm`/`bn` pin the
    kernels' rows and columns per block (`bn` only shapes the per-layer
    kernels); `tuned=true` grid-searches the unpinned ones (and the
    datapath, when none is forced) through the persistent autotuner;
    `explored=true` resolves the design-space explorer's winner for this
    plan shape when one exists. The predictor's `.plan_form`,
    `.datapath` and `.blocks` say what was chosen. `bkw` raises."""
    plan = lower_circuit(circuit)
    form, blocks, prebuilt = _resolve_datapath(
        plan, packed=packed, planes=planes, fusednet=fusednet, tuned=tuned,
        explored=explored, bm=bm, bn=bn, bkw=bkw, tuner=_tuner,
        device=device, multi=False)
    if prebuilt is not None:
        return prebuilt
    if form == "fusednet":
        return _build_fusednet(plan.planes(), blocks, device)
    return _build_single(_in_form(plan, form), blocks, device)


def compile_cuda_multi(plan: ExecutionPlan, *, device: torch.device,
                       packed: bool = False, planes: bool = False,
                       fusednet: bool = False, tuned: bool = False,
                       explored: bool = False, bm: int | None = None,
                       bn: int | None = None, bkw: int | None = None,
                       _tuner=None):
    """Multi-net dispatch over a *stacked* ExecutionPlan: uint8 images
    (M, B, n_in) -> int32 predictions (M, B). Both bit-plane options
    build ONE `binary_forward_planes` launch over grid (B/bm, M);
    `planes=true` falls back to the per-layer chain when the megakernel
    build raises ValueError. Dense and packed run the per-model chain,
    depth x M launches per call. The other options behave as in
    `compile_cuda`; tuning records for stacked plans are keyed on the
    stacked shape (model count included)."""
    if not plan.stacked:
        raise ValueError("compile_cuda_multi needs a stacked ExecutionPlan")
    form, blocks, prebuilt = _resolve_datapath(
        plan, packed=packed, planes=planes, fusednet=fusednet, tuned=tuned,
        explored=explored, bm=bm, bn=bn, bkw=bkw, tuner=_tuner,
        device=device, multi=True)
    if prebuilt is not None:
        return prebuilt
    plan = _in_form(plan, form)
    if form in ("planes", "fusednet"):
        try:
            return _build_fusednet(plan, blocks, device)
        except ValueError:
            if form == "fusednet":
                raise
    return _build_multi(plan, blocks, device)   # no megakernel view: chain


def compile_fused(circuit: Circuit, *, device: torch.device,
                  tuned: bool = False, bm: int | None = None, _tuner=None):
    """The paper's 2-layer net as ONE `fused_mlp_predict` launch per call
    over the dense plan's weights; a plan of any other depth raises
    IrregularCircuitError. `bm` pins the rows per block of the scalar
    route; `fused[tuned=true]` searches it per plan shape through the
    persistent autotuner (on the int8 tensor-core route every `bm` is
    the same 16-row kernel, so one candidate is measured). A net whose
    activations the route's shared memory cannot hold raises ValueError
    here, on every device."""
    from repro_torch.kernels.fused_mlp import ops as fused

    plan = lower_circuit(circuit)
    if plan.depth != 2:
        raise IrregularCircuitError(
            f"fused backend supports exactly 2 layers, got {plan.depth}")
    mma = _fits_int8(plan)
    if mma:
        w1, w2 = (bmv.mma_weights(torch.as_tensor(l.weights, dtype=torch.int8, device=device))
                  for l in plan.layers)
    else:
        w1, w2 = (torch.as_tensor(l.weights, dtype=torch.int32, device=device)
                  for l in plan.layers)
    thr = plan.input_threshold

    def build(bm):
        kbm = fused.check_fused(w1.shape[0], w1.shape[1], w2.shape[1], bm, mma=mma)

        def predict(x_uint8):
            telemetry.kernel_launches("fused").inc()
            return fused.fused_mlp_predict(as_device_images(x_uint8, device),
                                           w1, w2, threshold=thr, bm=kbm)

        return predict

    if tuned and bm is None:
        from repro_torch.netgen.analysis import tile_legality
        from repro_torch.netgen.tune import device_kind

        x = np.zeros((_TUNE_BATCH, plan.n_inputs), np.uint8)
        candidates = [{"bm": b} for b in _FUSED_TUNE_BM]
        legal = tile_legality(plan, batch=_TUNE_BATCH)
        bm = _tuner_or_default(_tuner).get_or_tune({
            "target": "fused",
            "device_kind": device_kind(device),
            "batch": _TUNE_BATCH,
            "signature": _plan_signature(plan),
            "candidates": candidates,
        }, candidates, lambda cand: _host_seconds(build(cand["bm"]), x),
            legal=lambda cand: legal({"form": "fused", **cand}))["bm"]

    return _finish_predictor(build(bm), plan=plan, arrays=(w1, w2), datapath="fused",
                             blocks={} if bm is None else {"bm": int(bm)},
                             launches=1)
