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
`blocks` and `launches_per_call`. On a CPU device the wrappers run the
kernels' plain versions. Tuning and explored records are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binary_matvec import ops as bmv
from repro_torch.netgen.backends.torch_ref import as_device_images
from repro_torch.netgen.graph import Circuit, IrregularCircuitError
from repro_torch.netgen.plan import ExecutionPlan, lower_circuit

__all__ = ["compile_cuda", "compile_cuda_multi", "compile_fused"]


def _resolve_form(packed: bool, planes: bool, fusednet: bool) -> str:
    """The requested datapath. `fusednet` runs the planes form, so
    planes+fusednet means fusednet; packed is a different activation
    encoding and stays exclusive. No option means dense."""
    if packed and (planes or fusednet):
        raise ValueError(
            "cuda: packed=true is exclusive with the bit-plane datapaths "
            "(planes=true / fusednet=true)")
    if fusednet:
        return "fusednet"
    if planes:
        return "planes"
    return "packed" if packed else "dense"


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


def _finish_predictor(predict, *, plan_form: str, datapath: str,
                      blocks: dict, launches: int):
    """Stamp the attributes callers read: the executed plan form, the
    datapath (the form, "fusednet" for the megakernel, "fused" for the
    2-layer kernel), the chosen blocks, and kernel launches per call."""
    predict.plan_form = plan_form
    predict.datapath = datapath
    predict.blocks = dict(blocks)
    predict.launches_per_call = launches
    return predict


def _build_single(plan: ExecutionPlan, blocks: dict, device: torch.device):
    arrays, run = _chain(plan, blocks, device)

    def predict(x_uint8):
        return run(as_device_images(x_uint8, device), *arrays)

    return _finish_predictor(predict, plan_form=plan.form, datapath=plan.form,
                             blocks=blocks, launches=plan.depth)


def _build_multi(plan: ExecutionPlan, blocks: dict, device: torch.device):
    arrays, run = _chain(plan, blocks, device)
    n_models = plan.n_models or 1

    def predict(x_uint8):                           # (M, B, n_in)
        x = as_device_images(x_uint8, device)
        return torch.stack([run(x[m], *[a[m] for a in arrays])
                            for m in range(n_models)])

    return _finish_predictor(predict, plan_form=plan.form, datapath=plan.form,
                             blocks=blocks, launches=plan.depth * n_models)


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
        return bmv.binary_forward_planes(
            as_device_images(x_uint8, device), *arrays,
            threshold=view.input_threshold, n_classes=view.n_classes, bm=bm,
            table=table)

    return _finish_predictor(predict, plan_form="planes", datapath="fusednet",
                             blocks=blocks, launches=1)


def compile_cuda(circuit: Circuit, *, device: torch.device,
                 packed: bool = False, planes: bool = False,
                 fusednet: bool = False, bm: int | None = None,
                 bn: int | None = None):
    """A predictor chaining one kernel launch per plan layer — dense
    (`binary_matmul`, no option), `packed=true` (`binary_matmul_packed`)
    or `planes=true` (`binary_matmul_planes`) — or ONE whole-net
    `binary_forward_planes` launch (`fusednet=true`). `bm`/`bn` pin the
    kernels' rows and columns per block (`bn` only shapes the per-layer
    kernels)."""
    form = _resolve_form(packed, planes, fusednet)
    plan = lower_circuit(circuit)
    blocks = {"bm": bm, "bn": bn}
    if form == "fusednet":
        return _build_fusednet(plan.planes(), blocks, device)
    return _build_single(_in_form(plan, form), blocks, device)


def compile_cuda_multi(plan: ExecutionPlan, *, device: torch.device,
                       packed: bool = False, planes: bool = False,
                       fusednet: bool = False, bm: int | None = None,
                       bn: int | None = None):
    """Multi-net dispatch over a *stacked* ExecutionPlan: uint8 images
    (M, B, n_in) -> int32 predictions (M, B). Both bit-plane options
    build ONE `binary_forward_planes` launch over grid (B/bm, M);
    `planes=true` falls back to the per-layer chain when the megakernel
    build raises ValueError. Dense and packed run the per-model chain,
    depth x M launches per call."""
    if not plan.stacked:
        raise ValueError("compile_cuda_multi needs a stacked ExecutionPlan")
    form = _resolve_form(packed, planes, fusednet)
    blocks = {"bm": bm, "bn": bn}
    plan = _in_form(plan, form)
    if form in ("planes", "fusednet"):
        try:
            return _build_fusednet(plan, blocks, device)
        except ValueError:
            if form == "fusednet":
                raise
    return _build_multi(plan, blocks, device)   # no megakernel view: chain


def compile_fused(circuit: Circuit, *, device: torch.device,
                  bm: int | None = None):
    """The paper's 2-layer net as ONE `fused_mlp_predict` launch per call
    over the dense plan's weights; a plan of any other depth raises
    IrregularCircuitError. `bm` pins the rows per block of the scalar
    route; a net whose activations the route's shared memory cannot hold
    raises ValueError here, on every device."""
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
    kbm = fused.check_fused(w1.shape[0], w1.shape[1], w2.shape[1], bm, mma=mma)
    thr = plan.input_threshold

    def predict(x_uint8):
        return fused.fused_mlp_predict(as_device_images(x_uint8, device),
                                       w1, w2, threshold=thr, bm=kbm)

    return _finish_predictor(predict, plan_form="dense", datapath="fused",
                             blocks={} if bm is None else {"bm": int(bm)},
                             launches=1)
