"""Seeded weights for a configuration, drawn on the device in a few calls.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference. The tree's layout (paths and shapes)
is the program's own declaration of its parameters; the values come from
the configuration file's `init` table, one rule for each leaf path, so
that a configuration states how its model is initialised. Every random
leaf is a view into one of two flat buffers: one `torch.rand` call for
the uniform rules and one `torch.randn` call for the normal rules, both
from one `torch.Generator` on the device seeded from `--seed`. The rules
then transform the views in place.

Rules (`[path, kind, {arguments}]`; a leaf under `layers` is stacked over
its first dim, which `fan_dim` does not count):

- `normal` {std}
- `uniform_fan` {scale, fan_dim}: U(-b, b), b = scale / sqrt(shape[fan_dim])
- `uniform` {lo, hi}
- `const` {value}
- `log_uniform` {lo, hi}: log of U(lo, hi) (Mamba2's `A_log`)
- `dt_bias` {dt_min, dt_max, floor}: softplus⁻¹ of dt, with dt log-uniform
  in [dt_min, dt_max] and at least `floor` (Mamba2's `dt_bias`)

`checksum` sums each leaf's 32-bit words, so that the check can tell
whether the program wrote into the tensors it was handed, which the
reference reads after it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["leaves", "draw", "checksum"]

STACKED = "layers"
_UNIFORM = ("uniform_fan", "uniform", "log_uniform", "dt_bias")


def leaves(tree: dict, prefix: tuple = ()) -> list[tuple[str, tuple, torch.dtype]]:
    """(dotted path, shape, dtype) of every leaf of an abstract tree of
    objects with `shape` and `dtype`, in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, prefix + (k,)))
        else:
            out.append((".".join(prefix + (k,)), tuple(v.shape), v.dtype))
    return out


def _rules(init: list) -> dict:
    rules = {}
    for path, kind, args in init:
        if path in rules:
            raise ValueError(f"init: {path} has two rules")
        rules[path] = (kind, args)
    return rules


def draw(abstract: dict, init: list, seed: int, device) -> dict:
    """The nested dict of tensors for `abstract`, each leaf by its rule."""
    device = torch.device(device)
    rules = _rules(init)
    spec = leaves(abstract)
    missing = [p for p, _, _ in spec if p not in rules]
    extra = sorted(set(rules) - {p for p, _, _ in spec})
    if missing or extra:
        raise ValueError(f"init rules do not match the tree: no rule for {missing}, "
                         f"rules for no leaf {extra}")
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    counts = {"u": 0, "n": 0}
    for path, shape, _ in spec:
        kind = rules[path][0]
        if kind in _UNIFORM:
            counts["u"] += math.prod(shape)
        elif kind == "normal":
            counts["n"] += math.prod(shape)
    bufs = {"u": torch.rand(counts["u"], generator=g, device=device),
            "n": torch.randn(counts["n"], generator=g, device=device)}
    at = {"u": 0, "n": 0}

    def take(which: str, shape) -> torch.Tensor:
        n = math.prod(shape)
        t = bufs[which][at[which]:at[which] + n].view(shape)
        at[which] += n
        return t

    flat: dict[str, torch.Tensor] = {}
    for path, shape, dtype in spec:
        kind, args = rules[path]
        inner = shape[1:] if path.split(".")[0] == STACKED else shape
        if kind == "normal":
            t = take("n", shape).mul_(args["std"])
        elif kind == "uniform_fan":
            b = args["scale"] / math.sqrt(inner[args["fan_dim"]])
            t = take("u", shape).mul_(2 * b).sub_(b)
        elif kind == "uniform":
            t = take("u", shape).mul_(args["hi"] - args["lo"]).add_(args["lo"])
        elif kind == "log_uniform":
            t = take("u", shape).mul_(args["hi"] - args["lo"]).add_(args["lo"]).log_()
        elif kind == "dt_bias":
            lo, hi = math.log(args["dt_min"]), math.log(args["dt_max"])
            dt = take("u", shape).mul_(hi - lo).add_(lo).exp_().clamp_(min=args["floor"])
            t = dt.add_(torch.log(-torch.expm1(-dt)))
        elif kind == "const":
            t = torch.full(shape, float(args["value"]), dtype=torch.float32, device=device)
        else:
            raise ValueError(f"init: unknown rule {kind!r} for {path}")
        flat[path] = t if t.dtype == dtype else t.to(dtype)
    return _nest(flat)


def checksum(tree: dict, prefix: tuple = (), chunk: int = 1 << 24) -> dict[str, int]:
    """{dotted path: the sum of the leaf's 32-bit words} of a tree of
    float32 tensors, summed `chunk` words at a time in int64 (exact: any
    change to one word changes the sum)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(checksum(v, prefix + (k,), chunk))
            continue
        words = v.detach().reshape(-1).view(torch.int32)
        out[".".join(prefix + (k,))] = sum(
            int(words[i:i + chunk].sum(dtype=torch.int64)) for i in range(0, words.numel(), chunk))
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out
