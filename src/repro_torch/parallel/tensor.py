"""Tensor parallelism of dense serving over the model axis.

The port's own module, as `parallel/data_parallel.py` is. The reference
serves under a mesh with TP-only rules (`repro/launch/serve.py`: batch
over "data", fsdp replicated) and lets GSPMD place each array by its
logical axes. The port's tensors are local, so the split is explicit:

* Parameters. Under a mesh whose "model" axis spans m > 1 ranks, each
  leaf of the dense family is cut along every dimension that
  `sharding.spec` maps to "model" (heads, kv_heads, ffn, vocab) into m
  contiguous slices, and rank r holds slice r: the shard the reference's
  `NamedSharding` places on model coordinate r (`shard_params`,
  `local_info`). A dimension that does not divide stays whole on every
  rank and is recorded in `sharding.fallbacks()`, entry for entry as the
  reference records it. The MoE, ssm and hybrid families keep their
  leaves whole (ROADMAP.md A.7c, A.7d).
* The KV cache follows spec(cache, ("batch", "kv_heads", "kv_seq",
  None)): by kv heads where they divide the axis, else by positions, rank
  r holding positions [r S/m, (r + 1) S/m). `cache_len` rounds a cache's
  length up to a multiple of m in the second case, so the layers can
  tell the two layouts apart from the cache's shape: a cache by kv heads
  has fewer heads than the config.
* The layers (`layers/{attention,mlp,embedding}.py`) read their split
  from their shards' shapes and reduce over `model_group()` with the two
  collectives here: `all_reduce` after each product whose contraction
  is split (attention's and the MLP's output projections, the
  vocab-split embedding), and `all_gather` of vocab-split logits. gloo,
  which holds several ranks on one card and on the CPU, has no
  reduce-scatter for CUDA tensors.

Only the "model" axis is cut here: a rank's rows of the batch are its
caller's (`Engine.generate`'s batch, the dry run's `serve_rows`), and
parameters are replicated over "data". W8 leaves under a model axis above
1 raise (ROADMAP.md A.7e).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.models import base
from repro_torch.models.base import ParamInfo, tree_items, tree_unflatten
from repro_torch.parallel import sharding as shd

__all__ = ["serving_rules", "model_group", "group_for", "local_info", "local_tree",
           "cache_len", "shard_params", "all_reduce", "all_gather"]

MODEL = "model"


_W8 = ("q", "s")     # the keys of a W8 leaf: int8 values, scales


def _w8_refused() -> NotImplementedError:
    return NotImplementedError(
        "W8 leaves under a model axis above 1 are not ported (ROADMAP.md, A.7e): serve the "
        "fp32 checkpoint, or W8 under model = 1")


def serving_rules() -> dict:
    """The reference launcher's serving rules: batch over "data" only,
    parameters replicated over it (TP-only)."""
    return {"batch": ("data",), "fsdp": ()}


def _model_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get(MODEL, 1)


def model_group():
    """The active mesh's "model" group; None when there is no mesh or the
    axis is 1."""
    mesh = shd.active_mesh()
    return None if _model_size(mesh) == 1 else mesh.group(MODEL)


def group_for(cfg):
    """The group a model of `cfg` serves split over: the model group for
    the dense family, None for the others (their leaves stay whole)."""
    return model_group() if cfg.family == "dense" else None


def _split_dims(info: ParamInfo) -> list[int]:
    """Dims of `info` that the active rules map onto "model"."""
    spec = tuple(shd.spec(tuple(info.shape), tuple(info.logical)))
    return [d for d, part in enumerate(spec)
            if part == MODEL or (isinstance(part, tuple) and MODEL in part)]


def _local_shape(info: ParamInfo, dims: list[int], m: int) -> tuple:
    return tuple(n // m if d in dims else n for d, n in enumerate(info.shape))


def local_info(info: ParamInfo) -> ParamInfo:
    """`info` at the shape of one rank's shard along "model" under the
    active mesh and rules."""
    m = _model_size(shd.active_mesh())
    if m == 1:
        return info
    return dataclasses.replace(info, shape=_local_shape(info, _split_dims(info), m))


def local_tree(cfg, tree) -> dict:
    """An abstract tree (parameters or cache) of `cfg` at its shards'
    shapes, visited in the reference's flatten order (so `fallbacks()`
    lists its entries in that order); unchanged outside the dense family
    or a model axis above 1."""
    if group_for(cfg) is None:
        return tree
    items = list(tree_items(tree))
    if any(p[-1] in _W8 for p, _ in items):
        raise _w8_refused()
    return tree_unflatten([p for p, _ in items], [local_info(i) for _, i in items])


def cache_len(cfg, max_len: int) -> int:
    """A cache length the layout can hold: under a model axis of m above 1
    whose split leaves kv heads whole (so the cache goes by positions),
    `max_len` rounded up to a multiple of m; else `max_len`. The extra
    positions are never valid."""
    m = _model_size(shd.active_mesh())
    if group_for(cfg) is None or cfg.n_kv_heads % m == 0:
        return max_len
    return -(-max_len // m) * m


def shard_params(cfg, params) -> dict:
    """This rank's shards of a dense parameter tree under the active mesh
    (leaves whole, or already at their shard's shape, which are kept):
    contiguous slices along each split dim, at the rank's model
    coordinate. Returns `params` unchanged outside the dense family or a
    model axis above 1. W8 leaves raise NotImplementedError."""
    if group_for(cfg) is None:
        return params
    from repro_torch.models import api
    mesh = shd.active_mesh()
    m, r = _model_size(mesh), mesh.coordinate(MODEL)
    infos = dict(tree_items(api.abstract_params(cfg)))
    paths, leaves = [], []
    for path, leaf in tree_items(params):
        if path[-1] in _W8:
            raise _w8_refused()
        info = infos[path]
        dims = _split_dims(info)
        if tuple(leaf.shape) == tuple(info.shape):
            for d in dims:
                n = leaf.shape[d] // m
                leaf = leaf.narrow(d, r * n, n)
            if dims:                            # a copy: the whole leaf can be freed
                leaf = leaf.clone(memory_format=torch.contiguous_format)
        elif tuple(leaf.shape) != _local_shape(info, dims, m):
            raise ValueError(f"{base.keystr(path)}: shape {tuple(leaf.shape)} is neither "
                             f"the leaf's {info.shape} nor its shard's")
        paths.append(path)
        leaves.append(leaf)
    return tree_unflatten(paths, leaves)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The elementwise reduction of x over `group` (a new tensor)."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's x along `dim`, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
