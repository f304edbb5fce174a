"""Declarative pass pipelines: parseable, nameable, fingerprintable.

A minimal counterpart of `repro/netgen/pipeline.py`. A spec is a comma
list of registered pass names:

    zeros    -> delete_zero_terms      (paper L4, per-term)
    prune    -> prune_dead_units       (paper L4, per-unit)
    addends  -> addend_rewrite         (paper L5, multiplication-free)

The named pipeline "default" is `zeros,prune`. A spec round-trips
through its canonical string (`spec_string()`), whose sha256 is its
`fingerprint()`, computed as the reference computes it. Unknown pass
names, options on passes that declare none, and duplicate steps raise
ValueError. The bracket-option syntax (`name[k=v,flag]`) is shared with
the target registry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Callable, Mapping

from repro_torch.netgen import passes as _passes
from repro_torch.netgen.graph import Circuit
from repro_torch.netgen.passes import PassStats, ops

__all__ = ["PASSES", "PipelineSpec", "parse_item", "render_opts"]

_FINGERPRINT_TAG = "netgen-pipeline-v1"
_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*$")

PASSES: dict[str, Callable[[Circuit], Circuit]] = {
    "zeros": _passes.delete_zero_terms,
    "prune": _passes.prune_dead_units,
    "addends": _passes.addend_rewrite,
}
_PIPELINES = {"default": "zeros,prune"}


# ---------------------------------------------------------------------------
# Bracket-option syntax, shared with the target registry
# ---------------------------------------------------------------------------

def _parse_value(raw: str):
    """Literal for one bracket-option value: bool, int, or bare string."""
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw, 10)
    except ValueError:
        return raw


def render_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def render_opts(opts: Mapping) -> str:
    """Canonical `[k=v,...]` suffix (sorted keys; empty -> no brackets)."""
    if not opts:
        return ""
    inner = ",".join(f"{k}={render_value(v)}" for k, v in sorted(opts.items()))
    return f"[{inner}]"


def parse_item(item: str) -> tuple[str, dict]:
    """Parse one `name` / `name[k=v,flag,...]` item into (name, opts). A
    bare option inside brackets is a boolean flag. Raises ValueError on
    malformed input."""
    item = item.strip()
    if "[" in item:
        name, _, rest = item.partition("[")
        if not rest.endswith("]"):
            raise ValueError(
                f"malformed options in {item!r}: missing closing ']'")
        body = rest[:-1]
        if "]" in body or "[" in body:
            raise ValueError(f"malformed options in {item!r}: nested brackets")
        opts: dict = {}
        for part in body.split(","):
            part = part.strip()
            if not part:
                raise ValueError(f"malformed options in {item!r}: empty option")
            k, eq, v = part.partition("=")
            k = k.strip()
            if not k:
                raise ValueError(
                    f"malformed options in {item!r}: option with no name")
            if k in opts:
                raise ValueError(f"duplicate option {k!r} in {item!r}")
            opts[k] = _parse_value(v.strip()) if eq else True
    else:
        name, opts = item, {}
    name = name.strip()
    if not name or not _NAME_RE.match(name):
        raise ValueError(f"malformed pass/target name {name!r} in {item!r}")
    return name, opts


# ---------------------------------------------------------------------------
# PipelineSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """An ordered tuple of registered pass names. See module doc."""
    steps: tuple[str, ...]

    @classmethod
    def parse(cls, spec: str) -> "PipelineSpec":
        if not isinstance(spec, str):
            raise TypeError(f"PipelineSpec.parse takes a string, got {spec!r}")
        items = [m.strip() for m in spec.split(",")]
        if not items or any(not m for m in items):
            raise ValueError(
                f"empty item in pipeline spec {spec!r} (a spec is a comma "
                "list of pass names, e.g. 'zeros,prune')")
        steps: list[str] = []
        for item in items:
            name, opts = parse_item(item)
            if name not in PASSES:
                raise ValueError(
                    f"unknown pass {name!r} (registered: "
                    f"{', '.join(sorted(PASSES))})")
            if opts:
                raise ValueError(
                    f"unknown option {sorted(opts)[0]!r} for pass {name!r} "
                    "(declared: none)")
            if name in steps:
                raise ValueError(
                    f"duplicate pass {name!r} in spec {spec!r} (each pass "
                    "may appear once; rewrites are applied in order)")
            steps.append(name)
        return cls(steps=tuple(steps))

    @classmethod
    def named(cls, name: str) -> "PipelineSpec":
        if name not in _PIPELINES:
            raise ValueError(
                f"unknown pipeline {name!r} (registered: "
                f"{', '.join(sorted(_PIPELINES))})")
        return cls.parse(_PIPELINES[name])

    @classmethod
    def coerce(cls, value) -> "PipelineSpec":
        """None -> "default"; a PipelineSpec -> itself; a string -> a
        named pipeline or a parsed spec."""
        if value is None:
            return cls.named("default")
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            if value in _PIPELINES:
                return cls.named(value)
            return cls.parse(value)
        raise TypeError(f"cannot make a PipelineSpec from {value!r}")

    def spec_string(self) -> str:
        """The canonical string; `parse(spec_string())` is the identity."""
        return ",".join(self.steps)

    def fingerprint(self) -> str:
        """sha256 of the canonical spec string (version-tagged)."""
        h = hashlib.sha256()
        h.update(f"{_FINGERPRINT_TAG}:{self.spec_string()}".encode())
        return h.hexdigest()

    def __str__(self) -> str:
        return self.spec_string()

    def run(self, circuit: Circuit) -> tuple[Circuit, tuple[PassStats, ...]]:
        """Apply the pipeline, recording per-pass stats."""
        stats = []
        for name in self.steps:
            before = ops(circuit)
            circuit = PASSES[name](circuit)
            stats.append(PassStats(name=name, before=before, after=ops(circuit)))
        return circuit, tuple(stats)
