"""Model and config substrate of the port's LM stack.

Counterpart of `repro/models/base.py`. Each model declares its
parameters abstractly as a tree (nested dicts) of `ParamInfo(shape,
dtype, init)`; `tree_init` materializes it on a device from one
`torch.Generator`. The logical sharding axes of the reference have no
counterpart on one card and are dropped. The same seed gives other bits
than `jax.random`, so the tests carry weights across with
`models.convert.from_jax_params` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._device import resolve_device

__all__ = ["ArchConfig", "ShapeConfig", "ParamInfo", "tree_map", "layer", "tree_init",
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


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: tuple
    dtype: Any = torch.float32
    init: str = "normal"         # normal | zeros | ones | uniform
    scale: float = 1.0           # stddev multiplier for normal init
    fan: int = 0                 # index of the fan-in dim (1 for stacked (L, in, out))


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(tree, i: int):
    """Layer i's slice of a tree of stacked per-layer tensors (the step of
    the reference's `lax.scan` over layers)."""
    return tree_map(lambda t: t[i], tree)


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
