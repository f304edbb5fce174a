"""Tensor and expert parallelism over the model axis (the dense, MoE,
ssm and hybrid families), and the cut of their leaves over every mesh
axis.

The port's own module, as `parallel/data_parallel.py` is. The reference
places each array by its logical axes under a mesh and lets GSPMD insert
the collectives. The port's tensors are local, so the split is explicit:

* Parameters. Under a mesh, each leaf of the dense and MoE families is
  cut along every dimension that `sharding.spec` maps to a mesh axis of
  `axes` into contiguous slices, and a rank holds the slice at its coordinate
  along those axes: the shard the reference's `NamedSharding` places
  there (`shard_params`, `local_info`, `local_tree`; `gather_leaf`
  puts the whole leaf back together; `draw_keep` cuts each layer slice
  of a leaf as `base.tree_draw` draws it, so a rank never holds a whole
  stacked leaf). Serving cuts "model" alone (heads,
  kv_heads, ffn, vocab; its rules keep `fsdp` empty); training cuts
  "model" and "data" (`TRAIN_AXES`, the reference's `fsdp` rule: the
  d_model dim of each matrix, gathered a layer at a time by
  `parallel/fsdp.py`). A dimension that does not divide stays whole on
  every rank and is recorded in `sharding.fallbacks()`, entry for entry
  as the reference records it. The MoE family's attention, embedding
  and head are the dense family's; its expert leaves `wi`, `wg` (L, E,
  d, f) and `wo` (L, E, f, d) are cut along E over "model" (the
  reference's "experts" rule: rank r of m holds experts [r E/m,
  (r + 1) E/m), or all of them on every rank where m does not divide E,
  recorded), and in a train state along d over "data" too; the router
  (L, d, E) stays whole over "model" and is cut along d over "data" in a
  train state (ROADMAP.md A.7d; `layers/moe.py`).
* The Mamba2 mixer (ssm and hybrid) is cut over "model" by heads, not by
  the spec's contiguous slices: the spec's "ffn" slice
  of `in_proj`'s concatenated [z | x | B | C | dt] columns (and of the
  conv's [x | B | C] channels) would straddle the segments. Rank r of m
  holds heads [r H/m, (r + 1) H/m): their columns of z, x and dt, and
  the B and C columns of the groups they use (G/m groups a rank when m
  divides G; the one group ⌊r G/m⌋, shared with m/G - 1 other ranks,
  when G divides m); in the conv and its cache, those x, B and C
  channels. `out_proj`'s rows and the SSM cache's heads are the spec's
  slices, which are already head-aligned. Each such leaf carries its
  segments (`ParamInfo.segments`). When H % m != 0, or neither of G and
  m divides the other, the mixer stays whole on every rank, recorded in
  `fallbacks()` as ("ssm_heads", H, ...) or ("ssm_groups", G, ...).
  The per-head vectors (`a_log`, `dt_bias`, `d_skip`, `norm_scale`) are
  whole in the reference's spec and stay whole; the mixer indexes its
  heads. In a train state the fsdp dim of `in_proj` and `out_proj` (d)
  is cut over "data" besides: a contiguous slice of rows, whatever the
  head-aligned cut of the other dim.
* The KV cache follows spec(cache, ("batch", "kv_heads", "kv_seq",
  None)): by kv heads where they divide the axis, else by positions, rank
  r holding positions [r S/m, (r + 1) S/m). `cache_len` rounds a cache's
  length up to a multiple of m in the second case, so the layers can
  tell the two layouts apart from the cache's shape: a cache by kv heads
  has fewer heads than the config.
* The layers (`layers/{attention,mlp,embedding,moe}.py`) read their split
  from their shards' shapes and reduce over the model group with the
  Megatron pair of autograd collectives here: `copy_to` (identity
  forward, all-reduce backward) on the input of each product whose
  output is split (the q/k/v projections, the MLP's `wi`/`wg`, the
  vocab-split head), and `reduce_from` (all-reduce forward, identity
  backward) after each product whose contraction is split (attention's
  and the MLP's output projections, the vocab-split embedding).
  The MoE block puts `copy_to` on the tokens that enter its expert
  buffer and on the gates, and `reduce_from` on its partial output.
  Serving's head all-gathers its logits (`gather_from`); training keeps
  them split and takes the loss over the vocab with `vocab_nll`. The
  mixer's gated norm sums its squares over the group with `sum_over`
  (all-reduce forward and backward). Under `torch.no_grad()` these run
  the forward collectives and nothing else.
* Sequence parallelism between layers (ROADMAP.md A item 4), the
  reference's ("batch", "seq", None) hidden state: where a sequence of S
  divides the model group's m (`seq_splits`; for the ssm and hybrid
  families only under the `ssm_shard` flag's "mixed", the reference's
  default), rank r holds positions [r S/m, (r + 1) S/m) between layers
  (`seq_range`); else, at a decode step and on a ragged prompt, the
  hidden state stays whole, recorded in `fallbacks()` as the reference
  records it. A layer that needs the whole sequence gathers it with
  `gather_seq` (all-gather forward, reduce-scatter backward) in place of
  `copy_to`, and reduce-scatters its partial output back with
  `scatter_seq` (reduce-scatter forward, all-gather backward) in place
  of `reduce_from`; never both on one input, or a gradient is summed m
  times. A product whose weights stay whole over "model" (heads, ffn or
  vocab that do not divide, the norms, the MoE router, zamba2's shared
  `in_proj`) runs on the rank's positions, and the train step sums its
  gradient over the group once (`train/step.py`). Prefill's last
  position lives on the last rank: `last_row` brings it to every rank
  before the head.

* A W8 leaf `{"q", "s"}` (`quantized/apply.py`) of the dense, ssm and
  hybrid families is cut from the whole quantization, never quantized a
  shard at a time, so a rank's scales are the unmeshed ones bit for bit
  (ROADMAP.md A.7e). `q` is cut as its dense leaf is, by the spec's
  slices or a Mamba2 leaf's head runs. `s` (per first and last dim of a
  weight of three or more dims, else per last dim: `w8_infos`) takes
  the same cut along those dims and stays whole along the others:
  attention's `wq` (L, d, H, hd) keeps its (L, hd) scales whole while
  `q` goes by heads; the MLP's `wi`/`wg`, the head and a Mamba2
  `in_proj` cut their scales with the output dim; `wo`, `out_proj` and
  `tok` keep theirs whole; zamba2's shared `wo` (H, hd, d) cuts its (H,
  d) scales by heads with `q`. A W8 expert leaf of the MoE family is cut
  too, and raises at the MoE layer's forward, split or not
  (`layers/moe.py`).

gloo, which holds several ranks on one card and on the CPU, has no
reduce-scatter for CUDA tensors: `reduce_scatter` all-reduces and keeps
this rank's slice under gloo, and calls `reduce_scatter_tensor` under
NCCL (and the dry run's `fake` backend), picked by the group's backend.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.models import base, runtime
from repro_torch.models.base import ParamInfo, tree_items, tree_unflatten
from repro_torch.parallel import sharding as shd

__all__ = ["MODEL", "DATA", "TRAIN_AXES", "serving_rules", "training_rules", "model_group",
           "group_for", "splits", "local_info", "local_tree", "cache_len", "shard_leaf",
           "shard_params", "draw_keep", "gather_leaf", "split_axes", "ssm_splits", "ssm_runs",
           "seq_splits", "seq_range", "all_reduce", "all_gather", "reduce_scatter", "copy_to",
           "reduce_from", "gather_from", "sum_over", "gather_seq", "scatter_seq", "split_seq",
           "last_row", "vocab_nll"]

MODEL = "model"
DATA = "data"
TRAIN_AXES = (DATA, MODEL)     # what a train state is cut over
# the families whose trees are cut over the mesh
_SPLIT_FAMILIES = ("dense", "moe", "ssm", "hybrid")


_W8 = ("q", "s")     # the keys of a W8 leaf: int8 values, scales


def serving_rules(mesh=None) -> dict:
    """The reference launcher's serving rules, parameters replicated over
    the data axes (TP-only): the batch over "data" alone, or on a mesh
    with a "pod" axis the default batch rule, over ("pod", "data")."""
    return {"fsdp": ()} if mesh is not None and "pod" in mesh.shape else \
        {"batch": ("data",), "fsdp": ()}


def training_rules(mesh) -> dict:
    """The reference trainer's rules (`repro/launch/train.py`): the batch
    over "data" on a single pod; the defaults (batch over ("pod",
    "data"), fsdp over "data") on a mesh with a "pod" axis."""
    return {} if "pod" in mesh.shape else {"batch": ("data",)}


def _model_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get(MODEL, 1)


def model_group():
    """The active mesh's "model" group; None when there is no mesh or the
    axis is 1."""
    mesh = shd.active_mesh()
    return None if _model_size(mesh) == 1 else mesh.group(MODEL)


def group_for(cfg):
    """The group a model of `cfg` runs split over: the model group for
    every family that is cut (dense, MoE, ssm, hybrid), else None."""
    return model_group() if cfg.family in _SPLIT_FAMILIES else None


def splits(cfg, axes=(MODEL,)) -> bool:
    """Whether a tree of `cfg` is cut over `axes` under the active mesh:
    one of `axes` above 1, and the family one that is cut (dense, MoE,
    ssm, hybrid)."""
    mesh = shd.active_mesh()
    return (mesh is not None and cfg.family in _SPLIT_FAMILIES
            and any(mesh.shape.get(a, 1) > 1 for a in axes))


def seq_splits(cfg, S: int) -> bool:
    """Whether a hidden state of S positions of `cfg` is split along the
    sequence over the model group between layers: a model group, S a
    multiple of its size, the rules' "seq" on "model", and for the ssm
    and hybrid families the `ssm_shard` flag other than "heads" (the
    reference's default "mixed")."""
    group = group_for(cfg)
    if group is None or MODEL not in shd.rule_axes("seq") or S % dist.get_world_size(group):
        return False
    return cfg.family in ("dense", "moe") or runtime.flag("ssm_shard", "mixed") != "heads"


def seq_range(cfg, S: int) -> tuple[int, int] | None:
    """This rank's positions of a sequence of S, (first, count) =
    (r S/m, S/m), where `seq_splits`; else None. Under a model group a
    sequence that does not divide it is recorded in `fallbacks()` as the
    reference records its ("batch", "seq", None) hidden state: ("seq", S,
    ("model",), None)."""
    group = group_for(cfg)
    if group is None:
        return None
    m = dist.get_world_size(group)
    if S % m and MODEL in shd.rule_axes("seq"):
        shd.record_fallback("seq", S, (MODEL,), None)
    if not seq_splits(cfg, S):
        return None
    return dist.get_rank(group) * (S // m), S // m


def ssm_splits(H: int, G: int, m: int) -> bool:
    """Whether a Mamba2 mixer of H heads in G groups splits by heads over
    m ranks: H % m == 0, and m divides G or G divides m."""
    return H % m == 0 and (G % m == 0 or m % G == 0)


def ssm_runs(segments: tuple, H: int, G: int, m: int, r: int) -> list[tuple[int, int]]:
    """(start, length) of each run of indices that rank r of m holds along
    a Mamba2 leaf's cut dim: per segment ("heads" or "groups", `width`
    indices a unit), its heads [r H/m, (r + 1) H/m), or the groups those
    heads use (head h is in group h // (H/G))."""
    hl = H // m
    h0, rep = r * hl, H // G
    g0, g1 = h0 // rep, (h0 + hl - 1) // rep + 1
    runs, off = [], 0
    for kind, width in segments:
        n, (a, b) = (H, (h0, h0 + hl)) if kind == "heads" else (G, (g0, g1))
        runs.append((off + a * width, (b - a) * width))
        off += n * width
    return runs


def _seg_cut(info: ParamInfo, mesh, names: tuple):
    """The cut of a Mamba2 leaf's segmented dim over `names`: the runs
    this rank holds, or () when the mixer stays whole (recorded)."""
    H, G, segments = info.segments
    m = mesh.size(names)
    if not ssm_splits(H, G, m):
        shd.record_fallback(*(("ssm_heads", H) if H % m else ("ssm_groups", G)), names, None)
        return ()
    return ssm_runs(segments, H, G, m, _index(mesh, names))


def _cuts(info: ParamInfo, axes) -> list[tuple[int, tuple[str, ...], list | None]]:
    """(dim, mesh axes, runs) of each dim of `info` that the active rules
    cut over axes of `axes` above 1: runs None for the spec's contiguous
    slice, else the (start, length) runs of a Mamba2 leaf's head-aligned
    cut (`ssm_runs`), which may leave the dim whole."""
    mesh = shd.active_mesh()
    out = []
    spec = tuple(shd.spec(tuple(info.shape), tuple(info.logical)))
    for d, part in enumerate(spec + (None,) * (len(info.shape) - len(spec))):
        if info.segments and info.logical[d] in ("ffn", "heads"):
            # the spec's record is kept; the cut is by heads, whatever
            # the spec's divisibility of the whole dim
            names = tuple(a for a in shd.rule_axes(info.logical[d])
                          if a in axes and mesh.shape[a] > 1)
            runs = _seg_cut(info, mesh, names) if names else ()
            if runs:
                out.append((d, names, runs))
            continue
        names = (part,) if isinstance(part, str) else tuple(part or ())
        names = tuple(a for a in names if a in axes and mesh.shape[a] > 1)
        if names:
            out.append((d, names, None))
    return out


def _local_shape(info: ParamInfo, cuts, mesh) -> tuple:
    shape = list(info.shape)
    for d, names, runs in cuts:
        shape[d] = shape[d] // mesh.size(names) if runs is None else sum(n for _, n in runs)
    return tuple(shape)


def local_info(info: ParamInfo, axes=(MODEL,)) -> ParamInfo:
    """`info` at the shape of one rank's shard along `axes` under the
    active mesh and rules."""
    mesh = shd.active_mesh()
    if mesh is None or all(mesh.shape.get(a, 1) == 1 for a in axes):
        return info
    return dataclasses.replace(info, shape=_local_shape(info, _cuts(info, axes), mesh))


def local_tree(cfg, tree, axes=(MODEL,)) -> dict:
    """An abstract tree (parameters, optimizer moments, cache, or the W8
    tree of `abstract_quantized_params`) of `cfg` at its shards' shapes
    along `axes`, visited in the reference's flatten order (so
    `fallbacks()` lists its entries in that order); unchanged unless
    `splits(cfg, axes)`."""
    if not splits(cfg, axes):
        return tree
    items = list(tree_items(tree))
    return tree_unflatten([p for p, _ in items], [local_info(i, axes) for _, i in items])


def cache_len(cfg, max_len: int) -> int:
    """A cache length the layout can hold: under a model axis of m above 1
    whose split leaves kv heads whole (so the cache goes by positions),
    `max_len` rounded up to a multiple of m; else `max_len`. The extra
    positions are never valid."""
    m = _model_size(shd.active_mesh())
    if group_for(cfg) is None or cfg.n_kv_heads % m == 0:
        return max_len
    return -(-max_len // m) * m


def _index(mesh, names) -> int:
    """This rank's index along `names` (mixed radix, in their order)."""
    i = 0
    for a in names:
        i = i * mesh.shape[a] + mesh.coordinate(a)
    return i


def _narrow(leaf: torch.Tensor, cuts, mesh) -> torch.Tensor:
    """`leaf` cut by `cuts` (`_cuts`' triples): a view of the contiguous
    slice along each cut dim, or a Mamba2 leaf's head-aligned runs."""
    for d, names, runs in cuts:
        if runs is None:
            n = leaf.shape[d] // mesh.size(names)
            leaf = leaf.narrow(d, _index(mesh, names) * n, n)
        else:
            leaf = torch.cat([leaf.narrow(d, a, n) for a, n in runs], dim=d)
    return leaf


def shard_leaf(info: ParamInfo, leaf: torch.Tensor, axes=(MODEL,), name: str = "") -> torch.Tensor:
    """This rank's shard of `leaf` (whole, or already at its shard's
    shape, which is kept): contiguous slices along each cut dim, or a
    Mamba2 leaf's head-aligned runs."""
    mesh = shd.active_mesh()
    cuts = _cuts(info, axes)
    if tuple(leaf.shape) == tuple(info.shape):
        leaf = _narrow(leaf, cuts, mesh)
        if cuts:                               # a copy: the whole leaf can be freed
            leaf = leaf.clone(memory_format=torch.contiguous_format)
    elif tuple(leaf.shape) != _local_shape(info, cuts, mesh):
        raise ValueError(f"{name}: shape {tuple(leaf.shape)} is neither the leaf's "
                         f"{info.shape} nor its shard's")
    return leaf


def shard_params(cfg, params, axes=(MODEL,)) -> dict:
    """This rank's shards of a parameter tree (or of a tree of the same
    shapes: AdamW's moments; or of a W8 tree, whose `q` and `s` take
    `w8_infos` of their dense leaf) under the active mesh, along `axes`:
    `shard_leaf` of every leaf. Returns `params` unchanged unless
    `splits(cfg, axes)`."""
    if not splits(cfg, axes):
        return params
    from repro_torch.models import api
    from repro_torch.quantized.apply import w8_infos
    infos = dict(tree_items(api.abstract_params(cfg)))
    paths, leaves = [], []
    for path, leaf in tree_items(params):
        info = (w8_infos(infos[path[:-1]])[path[-1]]
                if path[-1] in _W8 and path[:-1] in infos else infos[path])
        paths.append(path)
        leaves.append(shard_leaf(info, leaf, axes, base.keystr(path)))
    return tree_unflatten(paths, leaves)


def draw_keep(cfg, axes=(MODEL,)):
    """The `keep` of `models.base.tree_draw` that holds this rank's shards
    of a parameter tree of `cfg` under the active mesh, along `axes`; None
    unless `splits(cfg, axes)`. `keep(path, info, part, i)` cuts a drawn
    part, the whole leaf (`i` None) or layer `i`'s slice of a stacked one,
    or a W8 leaf's `{"q", "s"}` quantized from that part whole (each cut
    by `w8_infos` of the dense leaf). A slice takes its leaf's cut on the
    dims after the first: no cut touches the layers dim, so the cut of a
    slice is the slice of `shard_leaf`'s shard, bit for bit, and a rank
    never holds more of a stacked leaf than its shard and one slice. Each
    leaf's cut is taken once, so `fallbacks()` records it once."""
    if not splits(cfg, axes):
        return None
    from repro_torch.quantized.apply import w8_infos
    mesh = shd.active_mesh()
    cuts: dict = {}

    def cut(path, info: ParamInfo, part: torch.Tensor, i) -> torch.Tensor:
        if path not in cuts:
            cuts[path] = _cuts(info, axes)
        if i is None:                          # a copy: the whole leaf can be freed
            return _narrow(part, cuts[path], mesh).clone(
                memory_format=torch.contiguous_format) if cuts[path] else part
        if any(d == 0 for d, _, _ in cuts[path]):
            raise ValueError(f"{base.keystr(path)}: a stacked leaf cut along its layers")
        return _narrow(part, [(d - 1, names, runs) for d, names, runs in cuts[path]], mesh)

    def keep(path, info: ParamInfo, part, i):
        if isinstance(part, dict):
            infos = w8_infos(info)
            return {k: cut(path + (k,), infos[k], v, i) for k, v in part.items()}
        return cut(path, info, part, i)

    return keep


def gather_leaf(info: ParamInfo, leaf: torch.Tensor, axes=(MODEL,)) -> torch.Tensor:
    """The whole leaf from every rank's shard (an all-gather over each cut
    dim's axes; a Mamba2 leaf's runs put back in place, a group that
    several ranks hold taken from the last of them); a whole leaf is
    returned as it is."""
    mesh = shd.active_mesh()
    for d, names, runs in _cuts(info, axes):
        if leaf.shape[d] == info.shape[d]:
            continue
        if runs is None:
            leaf = all_gather(leaf, mesh.group(names), dim=d)
            continue
        H, G, segments = info.segments
        m = mesh.size(names)
        parts = _gather_parts(leaf, mesh.group(names))
        shape = list(leaf.shape)
        shape[d] = info.shape[d]
        whole = leaf.new_empty(shape)
        for q, part in enumerate(parts):
            at = 0
            for a, n in ssm_runs(segments, H, G, m, q):
                whole.narrow(d, a, n).copy_(part.narrow(d, at, n))
                at += n
        leaf = whole
    return leaf


def split_axes(cfg, tree) -> list[tuple[str, ...]]:
    """For each leaf of a parameter-shaped tree (in flatten order), the
    mesh axes its shape is cut over, read from the leaf's shape against
    the whole one: a dim shorter than the whole is cut over the axes the
    active rules map its logical axis to. () for a whole leaf."""
    mesh = shd.active_mesh()
    if mesh is None or cfg.family not in _SPLIT_FAMILIES:
        return [()] * len(list(tree_items(tree)))
    from repro_torch.models import api
    infos = dict(tree_items(api.abstract_params(cfg)))
    out = []
    for path, leaf in tree_items(tree):
        info, axes = infos[path], set()
        for d, n in enumerate(info.shape):
            if leaf.shape[d] < n:
                axes.update(shd.rule_axes(info.logical[d]))
        out.append(tuple(a for a in mesh.shape if a in axes))
    return out


# -- collectives ---------------------------------------------------------------

def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The elementwise reduction of x over `group` (a new tensor)."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _gather_parts(x: torch.Tensor, group) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's x along `dim`, in rank order."""
    return torch.cat(_gather_parts(x, group), dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along `dim` of the sum of x over `group`: NCCL's
    (and the `fake` backend's) reduce-scatter, or under gloo, which has
    none for CUDA tensors, an all-reduce and this rank's slice."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    if "gloo" in str(dist.get_backend(group)):
        return all_reduce(x, group).narrow(dim, r * size, size).contiguous()
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((size,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, dim=1), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, dim=1), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[1] // dist.get_world_size(group)
        return x.narrow(1, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, dim=1), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over `group`: the input of a product
    whose output is split over the group (each rank's gradient is its
    share of the whole). Without autograd (serving), x itself."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` (the output of a product whose
    contraction is split); its gradient goes to x unchanged."""
    return _ReduceFrom.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, where every rank's result feeds only its
    own share of what follows (the mixer's gated norm: each rank's
    channels read the sum of all ranks' squares): the gradient is summed
    over the group too."""
    return _SumOver.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's x along `dim`, in rank order; the gradient of this
    rank's slice goes to x."""
    return _GatherFrom.apply(x, group, dim)


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's positions of x (B, S/m, ...) along the sequence (dim
    1), in rank order: the whole (B, S, ...). Its backward reduce-scatters
    the gradient: each rank's gradient of the whole sequence is its part
    (from its heads, ffn columns, experts or queries), and the sum of the
    parts at this rank's positions is x's. It takes the place of
    `copy_to` where the hidden state is split along the sequence."""
    return _GatherSeq.apply(x, group)


def scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's positions (along dim 1) of the sum of x over `group`: a
    reduce-scatter, where `reduce_from` would all-reduce the whole
    sequence. Its backward all-gathers the positions' gradients."""
    return _ScatterSeq.apply(x, group)


def split_seq(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's positions (along dim 1) of x, which is the same on
    every rank; its backward all-gathers the positions' gradients, so the
    gradient of x is whole and the same on every rank (the counterpart of
    `gather_from` along the sequence)."""
    return _SplitSeq.apply(x, group)


def last_row(h: torch.Tensor, group, seq) -> torch.Tensor:
    """The last position of the whole sequence, h[:, -1:], on every rank:
    with the sequence split (`seq`, `seq_range`'s) it lives on the last
    rank, and is all-gathered from every rank's last row."""
    if seq is None:
        return h[:, -1:]
    return all_gather(h[:, -1:], group, dim=1)[:, -1:]


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lf, targets, group):
        Vl = lf.shape[-1]
        ids = targets.long() - dist.get_rank(group) * Vl
        mine = (ids >= 0) & (ids < Vl)
        ids = ids.clamp(0, Vl - 1)
        top = all_reduce(lf.amax(dim=-1, keepdim=True), group, dist.ReduceOp.MAX)
        e = torch.exp(lf - top)
        total = all_reduce(e.sum(dim=-1, keepdim=True), group)
        tgt = torch.take_along_dim(lf, ids[..., None], dim=-1)
        tgt = all_reduce(torch.where(mine[..., None], tgt, torch.zeros_like(tgt)), group)
        ctx.save_for_backward(e, total, ids, mine)
        return (torch.log(total) + top - tgt)[..., 0]

    @staticmethod
    def backward(ctx, g):
        e, total, ids, mine = ctx.saved_tensors
        d = e / total                                   # this rank's columns of the softmax
        d.scatter_add_(-1, ids[..., None], -mine[..., None].to(d.dtype))
        return d.mul_(g[..., None]), None, None


def vocab_nll(lf: torch.Tensor, targets: torch.Tensor, group) -> torch.Tensor:
    """The next-token negative log-likelihood from vocab-split fp32
    logits: lf (..., V / m) holds this rank's contiguous slice of the
    vocab over `group`. The log-sum-exp takes the max over the group (an
    all-reduce MAX, no gradient) and the sum of the exponentials over it;
    the target's logit comes from the rank that holds it (masked, summed).
    The backward is local: this rank's columns of softmax minus the
    one-hot, times the upstream gradient."""
    return _VocabNLL.apply(lf, targets, group)
