"""Post-training int8 weight quantization and structural pruning stats of
an LM checkpoint (the paper's integer-weight technique at LM scale).

Counterpart of `repro/quantized/apply.py`, in torch on the tensors'
own device (a full-width checkpoint is quantized on the card). Rounding
is `torch.round`, half to even, as `np.round` in the reference. Leaves
of a quantized tree are tensors or `{"q": int8, "s": fp32}`; paths are
named as the reference names them (`['layers']['mixer']['in_proj']`),
so the same filters select the same leaves. `abstract_quantized_params`
declares the W8 serving tree without making a tensor; `serving_leaf`
quantizes one leaf of it, or one layer slice of a stacked leaf as
`base.tree_draw` draws it, to the whole leaf's `q` and `s` bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.models import api
from repro_torch.models.base import ParamInfo

__all__ = ["QUANT_MIN_SIZE", "quantize_leaf", "quantize_tree", "dequantize_tree", "w8_infos",
           "abstract_quantized_params", "serving_leaf", "quantize_params_for_serving",
           "prune_stats"]

QUANT_MIN_SIZE = 1 << 14      # don't quantize tiny tensors (norms, biases)

# serving-path quantization allowlist: the big matmul weights only
_QUANT_NAMES = re.compile(r"\['(wq|wk|wv|wo|wi|wg|in_proj|out_proj|head|tok)'\]$")


def _is_q(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def _leaves(tree, path: str = ""):
    """(path, leaf) pairs in sorted key order; {"q","s"} dicts are leaves."""
    if isinstance(tree, dict) and not _is_q(tree):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}['{k}']")
    else:
        yield path, tree


def _rebuild(tree, fn, path: str = ""):
    if isinstance(tree, dict) and not _is_q(tree):
        return {k: _rebuild(v, fn, f"{path}['{k}']") for k, v in tree.items()}
    return fn(path, tree)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_weight(path: str, x: torch.Tensor, min_size: int = QUANT_MIN_SIZE) -> bool:
    if x.dim() < 2 or x.numel() < min_size:
        return False
    # never quantize rotary/positional tables or optimizer state
    return not any(s in path for s in ("norm", "scale", "bias"))


def _quantize(x: torch.Tensor, s_b: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8, in place on one fp32 temporary."""
    t = x.float() / s_b
    return t.round_().clamp_(-127, 127).to(torch.int8)


def quantize_leaf(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (last dim) symmetric int8."""
    amax = torch.clamp_min(x.abs().reshape(-1, x.shape[-1]).amax(dim=0), 1e-8)
    s = (amax / 127.0).float()
    return _quantize(x, s), s


def quantize_tree(params, *, min_size: int = QUANT_MIN_SIZE) -> tuple[dict, dict]:
    """Returns (quantized storage tree, stats). Leaves are either tensors
    (small ones) or {"q": int8, "s": fp32 scales}."""
    stats = {"bytes_before": 0, "bytes_after": 0, "n_quantized": 0, "n_leaves": 0}

    def one(path, arr):
        stats["n_leaves"] += 1
        stats["bytes_before"] += _nbytes(arr)
        if _is_weight(path, arr, min_size):
            q, s = quantize_leaf(arr)
            stats["bytes_after"] += _nbytes(q) + _nbytes(s)
            stats["n_quantized"] += 1
            return {"q": q, "s": s}
        stats["bytes_after"] += _nbytes(arr)
        return arr

    out = _rebuild(params, one)
    stats["compression"] = stats["bytes_before"] / max(stats["bytes_after"], 1)
    return out, stats


def dequantize_tree(qtree, dtype=torch.float32):
    """Fake-quant materialization: int8 storage -> fp32 weights carrying
    the quantization error (the accuracy-evaluation path)."""
    return _rebuild(qtree, lambda path, leaf: leaf["q"].float() * leaf["s"]
                    if _is_q(leaf) else leaf)


def _served_as_int8(path: str, shape, min_size: int) -> bool:
    """Whether the serving checkpoint stores this leaf as int8 + scales."""
    return len(shape) >= 2 and math.prod(shape) >= min_size and bool(_QUANT_NAMES.search(path))


def w8_infos(info: ParamInfo) -> dict:
    """The {"q", "s"} infos of the W8 leaf that serves a dense leaf of
    `info`: q is `info` at int8 (its segments kept); s holds the scales,
    per (first dim, last dim) for a weight of three or more dims, else per
    last dim, with those dims' logical axes, and keeps the segments where
    the segmented dim (a Mamba2 `in_proj`'s "ffn") is the last dim."""
    dims = (0, -1) if len(info.shape) >= 3 else (-1,)
    segmented = info.segments and info.logical[-1] in ("ffn", "heads")
    return {"q": dataclasses.replace(info, dtype=torch.int8, init="zeros"),
            "s": ParamInfo(tuple(info.shape[d] for d in dims), torch.float32,
                           tuple(info.logical[d] for d in dims), init="ones",
                           segments=info.segments if segmented else ())}


def abstract_quantized_params(cfg, *, min_size: int = QUANT_MIN_SIZE) -> dict:
    """The abstract (ParamInfo) tree of the W8 serving checkpoint, made
    without allocating: the leaves `quantize_params_for_serving` quantizes
    become `w8_infos`' {"q": int8, "s": fp32 scales}, with per-(stack,
    out-channel) scales, (L, last), for stacked weights, and the same
    logical axes."""
    def one(path, info):
        return w8_infos(info) if _served_as_int8(path, info.shape, min_size) else info

    return _rebuild(api.abstract_params(cfg), one)


def serving_leaf(path: str, x: torch.Tensor, *, shape=None, min_size: int = QUANT_MIN_SIZE):
    """One leaf of the serving checkpoint: `x` itself, or real int8 +
    scales `{"q", "s"}` where `_served_as_int8` picks the leaf by its
    path and its whole `shape` (`x`'s unless given). A whole weight of
    three or more dims takes per-(first, last) scales: per (layer,
    out-channel) for a stacked one. `shape` given and longer than `x`'s
    means `x` is one layer slice of a stacked leaf (`base.tree_draw`): its
    per-last-dim scales and values are then the whole leaf's row for that
    layer, bit for bit, so a tree quantized a slice at a time is the tree
    quantized whole."""
    whole = tuple(x.shape) if shape is None else tuple(shape)
    if not _served_as_int8(path, whole, min_size):
        return x
    if x.dim() >= 3 and x.dim() == len(whole):
        flatw = x.reshape(x.shape[0], -1, x.shape[-1])
        amax = torch.clamp_min(flatw.abs().amax(dim=1), 1e-8)               # (L, last)
        s = (amax / 127.0).float()
        s_b = s.reshape(x.shape[0], *([1] * (x.dim() - 2)), x.shape[-1])
        return {"q": _quantize(x, s_b), "s": s}
    if x.dim() < len(whole) < 3:
        raise ValueError(f"{path}: a slice of a {len(whole)}-dim leaf, whose scales "
                         "span its layers")
    q, s = quantize_leaf(x)
    return {"q": q, "s": s}


def quantize_params_for_serving(cfg, params, *, min_size: int = QUANT_MIN_SIZE):
    """Real int8 + scales for the big matmul weights, with per-(layer,
    out-channel) scales for stacked weights (ndim >= 3): `serving_leaf`
    of every leaf."""
    return _rebuild(params, lambda path, arr: serving_leaf(path, arr, min_size=min_size))


def prune_stats(params, threshold: float = 0.0) -> dict:
    """Structural zero analysis: per weight matrix, the fraction of output
    channels with max |w| <= threshold."""
    dead = total = 0
    for path, arr in _leaves(params):
        if not _is_weight(path, arr):
            continue
        chan_max = arr.abs().reshape(-1, arr.shape[-1]).amax(dim=0)
        dead += int((chan_max <= threshold).sum())
        total += arr.shape[-1]
    return {"dead_channels": dead, "total_channels": total,
            "dead_fraction": dead / max(total, 1)}
