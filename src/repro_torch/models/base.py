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
`models.convert.from_jax_params` instead.

Trees are nested dicts. `tree_items` walks one in the reference's
flatten order (sorted keys at every level) and names each leaf by its
path, written as `jax.tree_util.keystr` writes it (`['opt']['m']...`),
so checkpoints of the two packages share their leaf names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import runtime
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as shd

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "supports_shape", "ParamInfo", "is_info",
           "tree_map", "tree_items", "tree_unflatten", "keystr", "layer", "unstack",
           "remat_call", "sds", "tree_sds", "tree_specs", "tree_init", "count_params"]


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


def tree_init(tree, generator: torch.Generator, device=None):
    """Materialize an abstract tree on `device`. Leaves draw from the one
    `generator` in the tree's key order (sorted at each level), so the
    result depends only on the generator's seed and the tree. `device`
    None means `cuda:0` (`_device.resolve_device`)."""
    device = resolve_device(device)

    def mk(info: ParamInfo) -> torch.Tensor:
        if info.init == "zeros":
            return torch.zeros(info.shape, dtype=info.dtype, device=device)
        if info.init == "ones":
            return torch.ones(info.shape, dtype=info.dtype, device=device)
        if info.init == "normal":
            fan_in = info.shape[info.fan] if info.shape else 1
            std = info.scale / math.sqrt(max(fan_in, 1))
            t = torch.randn(info.shape, generator=generator, device=device,
                            dtype=torch.float32)
            return t.mul_(std).to(info.dtype)
        if info.init == "uniform":
            t = torch.rand(info.shape, generator=generator, device=device,
                           dtype=torch.float32)
            return t.mul_(2 * info.scale).sub_(info.scale).to(info.dtype)
        raise ValueError(info.init)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return mk(node)

    return walk(tree)


def count_params(tree) -> int:
    n = 0

    def add(info):
        nonlocal n
        n += math.prod(info.shape)

    tree_map(add, tree)
    return n
