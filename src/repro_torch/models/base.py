"""Model and config substrate of the port's LM stack.

Counterpart of `repro/models/base.py`. Each model declares its
parameters abstractly as a tree (nested dicts) of `ParamInfo(shape,
dtype, init)`; `tree_init` materializes it on a device from one
`torch.Generator`. Each `ParamInfo` carries the reference's logical
sharding axes (`logical`, one name or None per dim); `tree_specs` maps
them to `PartitionSpec`s under the active mesh and rules
(`parallel/sharding.py`), and `tree_sds` gives the abstract tree as
tensors on the `meta` device (shape and dtype, no storage), each with a
`sharding` attribute: its `sharding.NamedSharding` under an active mesh
(spec and `torch.distributed.tensor` placements), None outside one. The
same seed gives other
bits than `jax.random`, so the tests carry weights across with
`models.convert.from_jax_params` instead. `tree_draw` materializes a
tree a layer slice at a time, each leaf straight into its own dtype and
each slice from its own seeded generator, so a tree too large to exist
in fp32 on one card (qwen3-moe-30b-a3b's bf16 serving copy,
`serving_copy`), or a rank's shards of one (`keep`), can be drawn; its
values are not `tree_init`'s (ROADMAP.md, C).

Trees are nested dicts. `tree_items` walks one in the reference's
flatten order (sorted keys at every level) and names each leaf by its
path, written as `jax.tree_util.keystr` writes it (`['opt']['m']...`),
so checkpoints of the two packages share their leaf names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import runtime
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as shd

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "supports_shape", "ParamInfo", "is_info",
           "tree_map", "tree_items", "tree_unflatten", "keystr", "layer", "unstack",
           "remat_call", "sds", "tree_sds", "tree_specs", "tree_init", "tree_draw", "serving_copy",
           "count_params"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid
    modality: str = "text"      # text | vlm | audio
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    act: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = False
    scale_embedding: bool = False   # gemma: h *= sqrt(d_model)
    norm_plus_one: bool = False     # gemma: RMSNorm scale (1 + w), w initialized to 0
    pos: str = "rope"           # rope | mrope | sin
    rope_theta: float = 1e6
    mrope_sections: tuple = ()  # (t, h, w) half-dims, sum == head_dim // 2
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_norm_topk: bool = True
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    # hybrid (zamba2): one shared attention+MLP block applied every k layers
    attn_every: int = 0
    # hybrid, Zamba2's published layout (`models/zamba.py`), on where
    # `hybrid_layer_ids` is given: the layers whose mixer input takes the
    # shared block's output, `num_mem_blocks` blocks alternating over
    # them, the rank of each site's MLP adapter, and the mixers' gated
    # norm taken per group
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0
    ssm_group_norm: bool = False
    param_dtype: str = "float32"    # master params
    compute_dtype: str = "bfloat16"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        # channels passed through the causal conv: x, B, C
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    accum: int = 1               # gradient-accumulation microbatch steps


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", accum=8),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k needs a sub-quadratic sequence path: SSM/hybrid only.
    Everything else runs everywhere (every architecture is decoder-style)."""
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: tuple
    dtype: Any = torch.float32
    logical: tuple = ()          # logical sharding per dim (None = replicated)
    init: str = "normal"         # normal | zeros | ones | uniform
    scale: float = 1.0           # stddev multiplier for normal init
    fan: int = 0                 # index of the fan-in dim (1 for stacked (L, in, out))
    # a Mamba2 leaf's head-aligned cut over "model" (`parallel/tensor.py`):
    # (H, G, ((kind, width), ...)), the segments of its "ffn" or "heads"
    # dim, each H ("heads") or G ("groups") units of `width`
    segments: tuple = ()


def is_info(x) -> bool:
    return isinstance(x, ParamInfo)


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def keystr(path: tuple) -> str:
    """A leaf's path as `jax.tree_util.keystr` writes a dict path."""
    return "".join(f"[{k!r}]" for k in path)


def tree_items(tree, path: tuple = ()):
    """(path, leaf) for every leaf, in the reference's flatten order:
    sorted keys at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield path, tree


def tree_unflatten(paths, leaves) -> dict:
    """The nested-dict tree with `leaves` at `paths` (`tree_items`'s)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def layer(tree, i: int):
    """Layer i's slice of a tree of stacked per-layer tensors: a decode
    cache's, or one layer's parameters for a check. The models' loops
    over parameters use `unstack`."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree, n: int) -> list:
    """The n per-layer slices of a tree of stacked tensors (the steps of
    the reference's `lax.scan` over layers), each leaf split once by
    `torch.unbind`. Under autograd the slices' gradients are
    stacked once into the leaf's, where n `layer` slices would each
    write a zero-filled gradient of the whole stack."""
    parts = tree_map(torch.unbind, tree)       # leaves: tuples of n slices
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def remat_call(remat: str, fn, *args):
    """fn(*args); with remat "full" its activations are not kept but
    recomputed in the backward pass (`torch.utils.checkpoint`), the
    counterpart of the reference's `jax.checkpoint(..., nothing_saveable)`
    on a layer body. "none" keeps them.

    The recompute runs where autograd runs the backward, which for CUDA
    tensors is its device thread, not the caller's: it re-enters the
    forward's thread-local state there (the active mesh and rules, the
    runtime flags, the data-parallel reduction group), so it computes
    what the forward computed."""
    if remat == "full":
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=_forward_state)
    if remat != "none":
        raise ValueError(f"remat {remat!r} (want 'none' or 'full')")
    return fn(*args)


def _forward_state():
    """checkpoint's (forward, recompute) contexts: nothing for the forward;
    for the recompute, the thread-local state the forward ran under."""
    return contextlib.nullcontext(), _entered(shd.snapshot(), runtime.snapshot(),
                                              dp.snapshot())


@contextlib.contextmanager
def _entered(*ctxs):
    with contextlib.ExitStack() as stack:
        for ctx in ctxs:
            stack.enter_context(ctx)
        yield


def sds(shape, dtype, logical) -> torch.Tensor:
    """A `meta` tensor of `shape` and `dtype` whose `sharding` attribute is
    its `NamedSharding` under the active mesh (None outside one)."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    t.sharding = shd.named_sharding(tuple(shape), logical)
    return t


def _map_in_order(fn, tree):
    """tree_map visiting the leaves in the reference's flatten order, so
    `sharding.fallbacks()` records them in its order."""
    items = list(tree_items(tree))
    return tree_unflatten([p for p, _ in items], [fn(i) for _, i in items])


def tree_sds(tree):
    """Abstract tree -> the same tree of `meta`-device tensors (shape,
    dtype and `sharding`, no storage)."""
    return _map_in_order(lambda i: sds(i.shape, i.dtype, i.logical), tree)


def tree_specs(tree):
    """Abstract tree -> PartitionSpec tree under the active rules."""
    return _map_in_order(lambda i: shd.spec(i.shape, i.logical), tree)


def _draw(info: ParamInfo, shape, generator: torch.Generator, device) -> torch.Tensor:
    """A tensor of `shape` (the leaf's, or one layer slice's) filled by
    `info`'s init: zeros and ones in the leaf's dtype; the random inits in
    fp32, for the caller to cast, the normal init's std taken from the
    whole leaf's fan-in."""
    if info.init == "zeros":
        return torch.zeros(shape, dtype=info.dtype, device=device)
    if info.init == "ones":
        return torch.ones(shape, dtype=info.dtype, device=device)
    if info.init == "normal":
        fan_in = info.shape[info.fan] if info.shape else 1
        std = info.scale / math.sqrt(max(fan_in, 1))
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return t.mul_(std)
    if info.init == "uniform":
        t = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return t.mul_(2 * info.scale).sub_(info.scale)
    raise ValueError(info.init)


def tree_init(tree, generator: torch.Generator, device=None):
    """Materialize an abstract tree on `device`. Leaves draw from the one
    `generator` in the tree's key order (sorted at each level), so the
    result depends only on the generator's seed and the tree. `device`
    None means `cuda:0` (`_device.resolve_device`)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return _draw(node, node.shape, generator, device).to(node.dtype)

    return walk(tree)


STACKED = "layers"      # the top-level key whose leaves are stacked over layers


def _seed(seed: int, path: tuple, i: int | None) -> int:
    """A slice's generator seed: a stable hash (crc32, not Python's
    salted `hash`) of the draw's seed, the leaf's path and its layer."""
    return zlib.crc32(f"{seed}{keystr(path)}[{i}]".encode())


def _put(out, part, i: int) -> None:
    """Layer i of `out` (a tensor, or a dict of them) = `part`, leaf by
    leaf; a function, so that no loop variable outlives the copy."""
    for (_, o), (_, t) in zip(tree_items(out), tree_items(part)):
        o[i].copy_(t)


def tree_draw(tree, seed: int, device=None, *, keep=None):
    """Materialize an abstract tree on `device`, each leaf straight into
    its own dtype, a layer slice at a time: a leaf under the `layers` key
    is stacked over dim 0 (as `unstack` reads it) and is drawn slice by
    slice into a tensor allocated once; every other leaf is drawn whole.
    So no fp32 temporary exceeds one slice or one unstacked leaf, and a
    bf16 tree (`serving_copy`) never exists in fp32.

    Each slice (or unstacked leaf) draws from its own generator, seeded
    from (seed, path, layer) by `_seed`: its values depend on nothing
    else, not the tree's key order nor the other leaves. They are not
    `tree_init`'s values for the same seed, nor the reference's
    (ROADMAP.md, C).

    `keep(path, info, part, i)`, where given, maps each drawn part (the
    whole leaf, `i` None, or layer `i`'s slice of a stacked leaf, in the
    leaf's dtype; `info` is the whole leaf's) to what the tree holds of
    it: a tensor, or a dict of tensors (a W8 leaf's `{"q", "s"}`), each
    then stacked over the layers. `parallel/tensor.py` `draw_keep` keeps a
    rank's shards; `launch/serve.py` quantizes there too."""
    device = resolve_device(device)

    def leaf(path, info: ParamInfo):
        def drawn(shape, i):
            g = torch.Generator(device=device).manual_seed(_seed(seed, path, i))
            t = _draw(info, shape, g, device).to(info.dtype)
            return t if keep is None else keep(path, info, t, i)

        if path[0] != STACKED:
            return drawn(info.shape, None)
        out = None
        for i in range(info.shape[0]):
            one = drawn(info.shape[1:], i)
            if out is None:
                out = tree_map(lambda t: t.new_empty((info.shape[0], *t.shape)), one)
            _put(out, one, i)
            del one                 # freed before the next slice is drawn
        return out

    items = list(tree_items(tree))
    return tree_unflatten([p for p, _ in items], [leaf(p, i) for p, i in items])


def serving_copy(tree, dtype):
    """The abstract serving copy of a parameter tree (the reference's
    `serve_dtype` variant, `repro/launch/dryrun.py` `_serve_params_sds`):
    every fp32 leaf of two dims or more in `dtype` (a torch dtype or its
    name), every other leaf as it is."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def cast(i: ParamInfo) -> ParamInfo:
        if i.dtype == torch.float32 and len(i.shape) >= 2:
            return dataclasses.replace(i, dtype=dtype)
        return i

    return tree_map(cast, tree)


def count_params(tree) -> int:
    n = 0

    def add(info):
        nonlocal n
        n += math.prod(info.shape)

    tree_map(add, tree)
    return n
