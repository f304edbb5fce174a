"""Train-step factory: gradient accumulation over microbatches, remat, and
AdamW.

Counterpart of `repro/train/step.py`. The global batch is split into
`accum` microbatches, in order; each microbatch's gradients
come from `torch.autograd.grad` of `api.loss_fn` and are accumulated leaf
by leaf in fp32 as `gsum + g / accum`, as the reference's scan does, so
the sums round in its order. Inside a microbatch, `remat="full"`
recomputes each layer in the backward pass, so only one microbatch's
logits and one layer's activations are alive at a time.

The gradients are taken through views of the parameters
(`detach().requires_grad_()`): no copy of the weights is made. The step
then updates the state in place (`adamw.apply_updates`), the
counterpart of the reference's donated buffers, and returns it.

Under an active mesh (`parallel.sharding.use_mesh`) the step is data
parallel over the mesh's data axes ("pod", "data"), which may span one
rank: each rank takes its B / n rows of the global batch
(`data_parallel.local_rows`, whose microbatches are shares of the global
microbatches; every rank of a model group takes the same rows), and
computes the global batch's loss inside `data_parallel.reducing` and its
share of the gradients. Every family also runs under a model axis
above 1 (ROADMAP.md A.7b, A.7c, A.7d): its layers split over "model"
with autograd collectives (`parallel/tensor.py`; the Mamba2 mixer by
heads, `layers/mamba2.py`; the MoE block's experts, `layers/moe.py`,
whose router and input gradients come out whole from its `copy_to`s),
so every rank of a model group computes the same loss and its shards'
gradients. Their train
state may be cut over "data" too (FSDP, `parallel/fsdp.py`;
`shard_state`, `local_state`, `whole_state`): a leaf held as a data
shard gets its gradient reduce-scattered over "data" in each
microbatch's backward. After the accumulation the step sums only what
the backward has not: first, over the model group, the mixer's leaves
that a rank holds whole or shares with other ranks, whose backward
gives each rank only its heads' part (`mamba2.sum_partial_grads`: the
per-head vectors, and B and C where m > G); then every leaf that is not
a data shard over the data group (`data_parallel.reduce_grads`), and
the data shards over "pod" where the mesh has one. The global norm sums
each leaf's squares over the axes that cut it (`adamw.global_norm`),
counting a B or C column that m/G ranks share once
(`mamba2.norm_weights`), and AdamW updates the shards in place: the
shared copies get the same summed gradient and stay equal. What a leaf
is, whole or a shard, is read from its shape, so a whole state under a
mesh trains data parallel as before. The MoE router, whole over
"model", counts once in the norm. With the hidden state split along the
sequence (ROADMAP.md A item 4) a leaf held whole over "model" sees only
the rank's positions, so the model-group sum covers every such leaf
too (`_sum_positions`), once a step, before the sums over "data".
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.layers import mamba2
from repro_torch.models import api, runtime
from repro_torch.models.base import (ArchConfig, ShapeConfig, keystr, tree_items, tree_map,
                                     tree_unflatten)
from repro_torch.optim import adamw
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel import sharding as shd

__all__ = ["make_grad_fn", "make_train_step", "abstract_state", "local_state", "shard_leaf",
           "shard_state", "whole_state"]


def make_grad_fn(cfg: ArchConfig, shape: ShapeConfig, *, remat: str = "full"):
    """Returns grad_fn(params, batch) -> (loss, metrics, grads): the mean
    loss over the `shape.accum` microbatches and the fp32 gradients
    accumulated as the reference's train step accumulates them. With one
    microbatch, `metrics` are `loss_fn`'s; with more, they are empty, as
    in the reference. Under an active mesh, the global batch's loss and
    this rank's leaves' gradients, summed where the backward does not sum
    them (see the module's docstring)."""
    accum = max(shape.accum, 1)

    def grad_fn(params, batch):
        group = None
        mesh = shd.active_mesh()
        if mesh is not None:
            group, batch = _data_parallel(cfg, mesh, batch, accum)
        B = batch["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum {accum}")
        paths = [p for p, _ in tree_items(params)]
        loss_sum, gsum, metrics = None, None, {}
        with dp.reducing(group):
            for i in range(accum):
                mb = {k: v.reshape((accum, B // accum) + v.shape[1:])[i]
                      for k, v in batch.items()}
                with torch.enable_grad():
                    leaves = [t.detach().requires_grad_(True) for _, t in tree_items(params)]
                    loss, m = api.loss_fn(cfg, tree_unflatten(paths, leaves), mb, remat=remat)
                    grads = torch.autograd.grad(loss, leaves)
                loss = loss.detach()
                if accum == 1:
                    gsum, loss_sum = [g.float().contiguous() for g in grads], loss
                    metrics = tree_map(torch.Tensor.detach, m)
                elif gsum is None:
                    gsum = [g.float() / accum for g in grads]
                    loss_sum = loss / accum
                else:
                    for a, g in zip(gsum, grads):
                        a.add_(g.float() / accum)
                    loss_sum = loss_sum + loss / accum
                del grads
        if group is not None:
            _sum_partial(cfg, params, gsum, batch["tokens"].shape[1])
            _reduce(cfg, mesh, params, gsum, group)
        return loss_sum, metrics, tree_unflatten(paths, gsum)

    return grad_fn


_MIXER = ("layers", "mixer")      # the ssm and hybrid families' stacked mixer leaves


def _mixer_leaves(cfg: ArchConfig, tree) -> dict | None:
    """{name: index in flatten order} of the stacked mixer's leaves of a
    parameter-shaped tree under a model group; None otherwise."""
    if cfg.family not in ("ssm", "hybrid") or tensor.model_group() is None:
        return None
    return {p[-1]: i for i, (p, _) in enumerate(tree_items(tree)) if p[:2] == _MIXER}


def _sum_partial(cfg, params, gsum: list, S: int) -> None:
    """Sum over the model group the gradients that each rank holds only a
    part of: the mixer's, its heads' part (`mamba2.sum_partial_grads`);
    and with the hidden state split along the sequence (`tensor.seq_splits`
    of the batch's S), every other leaf that a rank holds whole over
    "model", its positions' part (`_sum_positions`)."""
    idx = _mixer_leaves(cfg, params)
    done = ()
    if idx:
        done = mamba2.sum_partial_grads(cfg, params["layers"]["mixer"],
                                        {k: gsum[i] for k, i in idx.items()},
                                        tensor.model_group())
    if tensor.seq_splits(cfg, S):
        _sum_positions(cfg, params, gsum, {_MIXER + (k,) for k in done})


def _sum_positions(cfg, params, gsum: list, done: set) -> None:
    """One all-reduce over the model group of the gradients of the leaves
    held whole over "model" (`tensor.split_axes`), but those in `done`
    and, under the "shardmap" MoE flag, the MoE block's (whose router
    `copy_to` makes whole): with the sequence split, a norm scale, a
    replicated attention or MLP weight, a whole vocab's `tok` and `head`,
    zamba2's shared `in_proj`, a whole mixer and the MoE router each
    see only this rank's positions."""
    shardmap = runtime.flag("moe_impl") == "shardmap"
    parts = [g for (path, _), axes, g in zip(tree_items(params), tensor.split_axes(cfg, params),
                                             gsum)
             if tensor.MODEL not in axes and path not in done
             and not (shardmap and path[:2] == ("layers", "moe"))]
    if not parts:
        return
    flat = torch.cat([g.reshape(-1) for g in parts])
    dist.all_reduce(flat, group=tensor.model_group())
    at = 0
    for g in parts:
        g.copy_(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()


def _reduce(cfg, mesh, params, gsum: list, group) -> None:
    """Sum the accumulated gradients where the backward has not: a leaf
    held as a data shard was reduce-scattered over the fsdp axes, so it
    is summed over the data axes left ("pod"); every other leaf over the
    whole data group, as `data_parallel.reduce_grads` does."""
    dims = fsdp.shard_dims(cfg, params)
    if not dims:
        dp.reduce_grads(gsum, group)
        return
    sharded = [p in dims for p, _ in tree_items(params)]
    dp.reduce_grads([g for g, s in zip(gsum, sharded) if not s], group)
    rest = tuple(a for a in _DATA_AXES if a in mesh.shape and a not in shd.rule_axes(fsdp.FSDP))
    if mesh.size(rest) > 1:
        dp.reduce_grads([g for g, s in zip(gsum, sharded) if s], mesh.group(rest))


_DATA_AXES = ("pod", "data")


def _data_parallel(cfg: ArchConfig, mesh, batch: dict, accum: int):
    """(the data group, this rank's rows of `batch`) under `mesh`."""
    axes = tuple(a for a in _DATA_AXES if a in mesh.shape)
    if not axes:
        raise ValueError(f"a training mesh needs a data axis, got {mesh.shape}")
    group = mesh.group(axes)
    return group, dp.local_rows(batch, accum, mesh.size(axes), dist.get_rank(group))


def make_train_step(cfg: ArchConfig, shape: ShapeConfig, oc: adamw.OptConfig,
                    *, remat: str = "full"):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt": {m, v, step}}, whole or this rank's shards
    (`shard_state`), updated in place; batch per data.pipeline, as tensors
    on the state's device. The metrics are `loss_fn`'s (one microbatch
    only), `grad_norm`, `lr` and `loss`."""
    grad_fn = make_grad_fn(cfg, shape, remat=remat)

    def train_step(state, batch):
        loss, metrics, grads = grad_fn(state["params"], batch)
        _, _, opt_metrics = adamw.apply_updates(state["params"], grads, state["opt"], oc,
                                                groups=_norm_groups(cfg, state["params"]),
                                                weights=_norm_weights(cfg, state["params"]))
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def _norm_groups(cfg: ArchConfig, params) -> list | None:
    """Per leaf (flatten order), the group its squares are summed over in
    the global norm: the mesh axes that cut it; None for a whole leaf, and
    None for all when nothing is cut."""
    axes = tensor.split_axes(cfg, params)
    if not any(axes):
        return None
    mesh = shd.active_mesh()
    return [mesh.group(a) if a else None for a in axes]


def _norm_weights(cfg: ArchConfig, params) -> list | None:
    """Per leaf (flatten order), the weights of its squares in the global
    norm along its last dim (`mamba2.norm_weights`: a shared B or C column
    counted on one rank), or None; None for all when none has any."""
    idx = _mixer_leaves(cfg, params)
    w = mamba2.norm_weights(cfg, params["layers"]["mixer"], tensor.model_group()) if idx else {}
    if not w:
        return None
    out = [None] * len(list(tree_items(params)))
    for k, t in w.items():
        out[idx[k]] = t
    return out


def abstract_state(cfg: ArchConfig) -> dict:
    """Abstract train state (ParamInfo trees): parameters and AdamW state."""
    ap = api.abstract_params(cfg)
    return {"params": ap, "opt": adamw.abstract_opt_state(ap)}


def _sharded(cfg: ArchConfig) -> bool:
    return tensor.splits(cfg, tensor.TRAIN_AXES)


def _infos(cfg: ArchConfig, path: tuple):
    """The parameter ParamInfo a state leaf at `path` mirrors (params, m,
    v), or None (the step count)."""
    if path[0] == "params":
        return dict(tree_items(api.abstract_params(cfg)))[path[1:]]
    if path[:2] in (("opt", "m"), ("opt", "v")):
        return dict(tree_items(api.abstract_params(cfg)))[path[2:]]
    return None


def local_state(cfg: ArchConfig) -> dict:
    """The abstract train state at one rank's shards' shapes under the
    active mesh and rules: the parameters, m and v cut over "data" (fsdp)
    and "model"; the whole state without a mesh."""
    st = abstract_state(cfg)
    if not _sharded(cfg):
        return st
    cut = lambda tree: tensor.local_tree(cfg, tree, tensor.TRAIN_AXES)  # noqa: E731
    return {"params": cut(st["params"]),
            "opt": {"m": cut(st["opt"]["m"]), "v": cut(st["opt"]["v"]),
                    "step": st["opt"]["step"]}}


def shard_leaf(cfg: ArchConfig, path: tuple, leaf: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the state leaf at `path` (whole, or already a
    shard), as `local_state` cuts it."""
    info = _infos(cfg, path) if _sharded(cfg) else None
    if info is None:
        return leaf
    return tensor.shard_leaf(info, leaf, tensor.TRAIN_AXES, keystr(path))


def shard_state(cfg: ArchConfig, state) -> dict:
    """This rank's shards of a whole train state (leaves already at their
    shards' shapes are kept)."""
    items = list(tree_items(state))
    return tree_unflatten([p for p, _ in items], [shard_leaf(cfg, p, t) for p, t in items])


def whole_state(cfg: ArchConfig, state) -> dict:
    """The whole train state from every rank's shards (an all-gather over
    each leaf's axes; every rank of the mesh takes part and gets it)."""
    if not _sharded(cfg):
        return state
    items = list(tree_items(state))
    out = []
    for p, t in items:
        info = _infos(cfg, p)
        out.append(t if info is None else tensor.gather_leaf(info, t, tensor.TRAIN_AXES))
    return tree_unflatten([p for p, _ in items], out)
