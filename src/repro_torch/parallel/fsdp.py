"""Fully sharded parameters over "data" (FSDP), in every family.

The port's own module, as `parallel/data_parallel.py` is. The reference
declares each matrix's d_model dim `fsdp` and maps it to "data"
(`DEFAULT_RULES`); GSPMD gathers a layer's weights where its scan body
uses them and reduce-scatters their gradients. Here a train state whose
leaves were cut over "data" (`parallel/tensor.py` `shard_params` with
`TRAIN_AXES`) holds 1 / n of each such leaf, and:

* `gather(shard, dim, group)` is the whole leaf along its fsdp dim, an
  autograd all-gather over the data group; its backward is a
  reduce-scatter (`tensor.reduce_scatter`: the sum over the group of the
  gathered gradient, then this rank's slice), so the shard's gradient
  is already summed over "data".
* `shard_dims(cfg, params)` reads which leaves are such shards from
  their shapes (a leaf shorter than whole along its `fsdp` dim), and
  `gather_tree` gathers them. `models/{transformer,mamba}.py` call it
  on a layer's slices inside the function that `remat_call`
  checkpoints, so only one layer's gathered weights are alive at a time
  and the recompute gathers again, as the reference's remat over its
  layer scan does; the embedding and head are gathered where they are
  used, and zamba2's shared block once a forward (`models/zamba.py`).

The MoE block's router and expert leaves are gathered with the rest of
their layer (`wi` and `wg` along d, their dim 2 of (L, E/m, d, f); `wo`
along its last dim, d; the router along d), and their gradients
reduce-scattered to the shards (ROADMAP.md A.7d).

A leaf whose fsdp dim does not divide the axis stays whole over "data"
(a `sharding.fallbacks()` entry) and its gradient is summed over the
data group after the step's accumulation (`train/step.py`), as every
leaf's is at a data axis of 1.
"""
from __future__ import annotations

import torch

from repro_torch.models.base import tree_items, tree_unflatten
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor

__all__ = ["FSDP", "group", "gather", "shard_dims", "gather_tree", "layer_dims", "sub_dims"]

FSDP = "fsdp"       # the logical axis of a leaf's FSDP dim


def group():
    """The process group the active rules cut `fsdp` dims over (the data
    axis); None without a mesh or when it spans one rank."""
    mesh = shd.active_mesh()
    axes = shd.rule_axes(FSDP)
    if mesh is None or mesh.size(axes) == 1:
        return None
    return mesh.group(axes)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return tensor.all_gather(shard, group, dim)

    @staticmethod
    def backward(ctx, g):
        return tensor.reduce_scatter(g, ctx.group, ctx.dim), None, None


def gather(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole leaf from every data rank's `shard` along `dim`; the
    gradient is reduce-scattered back (summed over `group`, this rank's
    slice)."""
    return _Gather.apply(shard, dim, group)


def shard_dims(cfg, params) -> dict | None:
    """{path: fsdp dim} of the leaves of `params` that hold a shard of
    their fsdp dim (shorter there than the whole leaf); None when there
    is none (no mesh, another family, a data axis of 1, whole leaves)."""
    if not tensor.splits(cfg, (tensor.DATA,)) or group() is None:
        return None
    from repro_torch.models import api
    infos = dict(tree_items(api.abstract_params(cfg)))
    out = {}
    for path, leaf in tree_items(params):
        info = infos.get(path)          # None: a W8 leaf's q or s
        if info is not None and FSDP in info.logical:
            d = info.logical.index(FSDP)
            if leaf.shape[d] < info.shape[d]:
                out[path] = d
    return out or None


def sub_dims(dims: dict | None, key: str, drop: int = 0) -> dict | None:
    """The entries of `dims` under `key` (`params[key]`'s leaves: "embed",
    zamba2's "shared"), their paths without it and their dims less `drop`
    (a layer slice has no layer dim)."""
    if not dims:
        return None
    out = {p[1:]: d - drop for p, d in dims.items() if p[0] == key}
    return out or None


def gather_tree(tree: dict, dims: dict | None) -> dict:
    """`tree` with each leaf at a path of `dims` gathered along its dim."""
    if not dims:
        return tree
    g = group()
    items = list(tree_items(tree))
    return tree_unflatten([p for p, _ in items],
                          [gather(t, dims[p], g) if p in dims else t for p, t in items])


def layer_dims(dims: dict | None) -> dict | None:
    """The fsdp dims of a layer's slices of `params["layers"]` (a stacked
    leaf's fsdp dim less its layer dim)."""
    return sub_dims(dims, "layers", drop=1)
