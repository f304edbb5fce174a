"""cuda backend: execute a planes-form ExecutionPlan on the bit-plane kernels.

Counterpart of `repro/netgen/backends/pallas.py`, for the bit-plane
datapaths only:

  planes    — the per-layer chain: inputs binarized straight into packed
              words, one `binary_matmul_planes` launch per layer,
              `sum_b 2^b (popc(x & pos_b) - popc(x & neg_b))`, and a
              strict step + repack (`step_pack`) between layers. Both
              operands travel as bits.
  fusednet  — the whole planes-form net (any depth up to the kernel's
              limit, single or stacked) as ONE `binary_forward_planes`
              launch through `plan.megakernel_view()`.

The stacked multi-net dispatch prefers the megakernel: `planes=true`
builds it and falls back to the per-layer chain when the plan has no
view the kernel takes; `fusednet=true` is strict. The chain sweeps the
model axis with a Python loop (depth x M launches per call against the
megakernel's 1).

Predictors take uint8 images (numpy or tensor), return int32 class ids
as a tensor on the compile device, and carry `plan_form`, `datapath`,
`blocks` and `launches_per_call`. On a CPU device the wrappers run the
kernels' plain versions. The dense and packed datapaths, tuning and
explored records are not ported yet: asking for them raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binary_matvec import ops as bmv
from repro_torch.netgen.backends.torch_ref import as_device_images
from repro_torch.netgen.graph import Circuit
from repro_torch.netgen.plan import ExecutionPlan, lower_circuit

__all__ = ["compile_cuda", "compile_cuda_multi"]


def _resolve_form(planes: bool, fusednet: bool) -> str:
    """The requested datapath. `fusednet` runs the planes form, so
    planes+fusednet means fusednet."""
    if fusednet:
        return "fusednet"
    if planes:
        return "planes"
    raise ValueError(
        "cuda: only the bit-plane datapaths are ported; pass planes=true "
        "or fusednet=true (the dense and packed datapaths come later)")


def _words(a, device: torch.device) -> torch.Tensor:
    """uint32 plane words (numpy) as an int32 tensor with the same bits."""
    return torch.from_numpy(a.view("int32")).to(device)


def _chain(plan: ExecutionPlan, blocks: dict, device: torch.device):
    """One version's per-layer chain over a planes-form plan.

    Returns (arrays, run): `arrays` is a flat tuple of per-layer pos/neg
    word tensors (leading model axis when the plan is stacked) and
    `run(x_uint8, *arrays)` maps one version's uint8 batch to int32
    class ids. The chain is packed end to end: binarize emits words,
    every hidden boundary is a `step_pack`.
    """
    assert plan.form == "planes", plan.form
    thr = plan.input_threshold
    bm, bn = bmv.check_matmul_blocks(blocks.get("bm"), blocks.get("bn"))
    arrays = []
    for layer in plan.layers:
        arrays.append(_words(layer.pos_planes, device))
        arrays.append(_words(layer.neg_planes, device))
    words = [l.words for l in plan.layers]
    fan_outs = [l.fan_out for l in plan.layers]

    def plane_matmul(a, pos, neg, fan_out):
        if pos.shape[-2] == 0:       # zero words: fully-pruned fan_in
            return torch.zeros((a.shape[0], fan_out), dtype=torch.int32,
                               device=a.device)
        return bmv.binary_matmul_planes(a, pos, neg, bm=bm, bn=bn)

    def run(x_uint8, *planes):
        a = bmv.binarize_pack(x_uint8, threshold=thr, words=words[0])
        for i in range(len(fan_outs) - 1):
            acc = plane_matmul(a, planes[2 * i], planes[2 * i + 1], fan_outs[i])
            a = bmv.step_pack(acc, words=words[i + 1])
        acc = plane_matmul(a, planes[-2], planes[-1], fan_outs[-1])
        return torch.argmax(acc, dim=-1).to(torch.int32)

    return tuple(arrays), run


def _finish_predictor(predict, *, plan_form: str, datapath: str,
                      blocks: dict, launches: int):
    """Stamp the attributes callers read: the executed plan form, the
    datapath ("planes" or "fusednet"), the chosen blocks, and kernel
    launches per call."""
    predict.plan_form = plan_form
    predict.datapath = datapath
    predict.blocks = dict(blocks)
    predict.launches_per_call = launches
    return predict


def _build_single(plan: ExecutionPlan, blocks: dict, device: torch.device):
    arrays, run = _chain(plan, blocks, device)

    def predict(x_uint8):
        return run(as_device_images(x_uint8, device), *arrays)

    return _finish_predictor(predict, plan_form="planes", datapath="planes",
                             blocks=blocks, launches=plan.depth)


def _build_multi(plan: ExecutionPlan, blocks: dict, device: torch.device):
    arrays, run = _chain(plan, blocks, device)
    n_models = plan.n_models or 1

    def predict(x_uint8):                           # (M, B, n_in)
        x = as_device_images(x_uint8, device)
        return torch.stack([run(x[m], *[a[m] for a in arrays])
                            for m in range(n_models)])

    return _finish_predictor(predict, plan_form="planes", datapath="planes",
                             blocks=blocks, launches=plan.depth * n_models)


def _build_fusednet(plan: ExecutionPlan, blocks: dict, device: torch.device):
    """The whole-net megakernel predictor: one `binary_forward_planes`
    launch per call, single (B, n_in) or stacked (M, B, n_in). Raises
    ValueError when the plan has no megakernel view the kernel takes
    (callers that merely prefer the megakernel fall back to the chain)."""
    view = plan.megakernel_view()
    bm = bmv.check_forward_planes(view.layer_words, blocks.get("bm"))
    arrays = tuple(_words(a, device) for a in view.arrays)

    def predict(x_uint8):
        return bmv.binary_forward_planes(
            as_device_images(x_uint8, device), *arrays,
            threshold=view.input_threshold, n_classes=view.n_classes, bm=bm)

    return _finish_predictor(predict, plan_form="planes", datapath="fusednet",
                             blocks=blocks, launches=1)


def compile_cuda(circuit: Circuit, *, device: torch.device,
                 planes: bool = False, fusednet: bool = False,
                 bm: int | None = None, bn: int | None = None):
    """A predictor chaining one `binary_matmul_planes` launch per plan
    layer (`planes=true`), or ONE whole-net `binary_forward_planes`
    launch (`fusednet=true`). `bm`/`bn` pin the kernels' rows and
    columns per block (`bn` only shapes the per-layer kernel)."""
    form = _resolve_form(planes, fusednet)
    plan = lower_circuit(circuit, form="planes")
    blocks = {"bm": bm, "bn": bn}
    if form == "fusednet":
        return _build_fusednet(plan, blocks, device)
    return _build_single(plan, blocks, device)


def compile_cuda_multi(plan: ExecutionPlan, *, device: torch.device,
                       planes: bool = False, fusednet: bool = False,
                       bm: int | None = None, bn: int | None = None):
    """Multi-net dispatch over a *stacked* ExecutionPlan: uint8 images
    (M, B, n_in) -> int32 predictions (M, B). Both bit-plane options
    build ONE `binary_forward_planes` launch over grid (B/bm, M);
    `planes=true` falls back to the per-layer chain (a loop over the
    models) when the megakernel build raises ValueError."""
    if not plan.stacked:
        raise ValueError("compile_cuda_multi needs a stacked ExecutionPlan")
    form = _resolve_form(planes, fusednet)
    blocks = {"bm": bm, "bn": bn}
    plan = plan.planes()
    try:
        return _build_fusednet(plan, blocks, device)
    except ValueError:
        if form == "fusednet":
            raise
    return _build_multi(plan, blocks, device)   # no megakernel view: chain
