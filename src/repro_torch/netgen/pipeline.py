"""Declarative pass pipelines: parseable, nameable, fingerprintable.

Counterpart of `repro/netgen/pipeline.py`. A spec is a comma list of
registry entries, each with optional bracketed options:

    PipelineSpec.parse("zeros,prune")
    PipelineSpec.parse("prune,addends,cse[budget=5000,bucketed=true]")

Registry names map onto `repro_torch.netgen.passes`:

    zeros    -> delete_zero_terms      (paper L4, per-term)
    prune    -> prune_dead_units       (paper L4, per-unit)
    addends  -> addend_rewrite         (paper L5, multiplication-free)
    cse      -> share_common_addends   (adder sharing; opts: budget=<int>
                maps to max_new_nodes, bucketed=<bool> selects the
                (sign, magnitude)-bucketed candidate search)

Named pipelines ("default" = `zeros,prune`, "hw" =
`zeros,prune,addends,cse`) resolve to full specs, and a spec round-trips
through its canonical string: sorted options, bare boolean flags
normalized to `opt=true`, full function names resolved to their
registry entry. The canonical string is what `fingerprint()` hashes
(sha256, computed as the reference computes it), so equal specs have
equal fingerprints in both packages. Unknown passes, unknown or
ill-typed options and duplicate steps raise ValueError. The
bracket-option syntax (`name[k=v,flag]`) is shared with the target
registry.

Dotted module paths are accepted for out-of-tree passes
(`"mypkg.passes.retime"` imports and calls `mypkg.passes.retime`), and
`PipelineSpec.from_passes` represents a sequence of pass callables —
registered functions, `functools.partial` of them (their keywords map
back to declared options: `cse[budget=2]`) and module-level functions
(by dotted name). Lambdas and closures have no stable fingerprint and
raise.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib
import re
from typing import Callable, Mapping, Sequence

from repro_torch.netgen import passes as _passes
from repro_torch.netgen import telemetry
from repro_torch.netgen.graph import Circuit
from repro_torch.netgen.passes import PassStats, ops

__all__ = [
    "PassDef", "PassSpec", "PipelineSpec", "check_opt_string",
    "list_passes", "list_pipelines", "parse_item", "register_pass",
    "register_pipeline", "render_opts",
]

_FINGERPRINT_TAG = "netgen-pipeline-v1"
_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*$")


# ---------------------------------------------------------------------------
# Bracket-option syntax, shared with the Target registry
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


_SAFE_STR_RE = re.compile(r"^[A-Za-z0-9_./\-]+$")


def check_opt_string(value: str, where: str) -> str:
    """String option values are embedded verbatim in canonical spec /
    target strings (which must round-trip through `parse_item` and key
    the artifact), so they may not contain the syntax characters
    `, [ ] =` or whitespace, and may not collide with bool/int
    literals."""
    if not _SAFE_STR_RE.match(value):
        raise ValueError(
            f"{where}: string option value {value!r} must match "
            "[A-Za-z0-9_./-]+ — it is embedded in the canonical spec "
            "string that keys the artifact store")
    if not isinstance(_parse_value(value), str):
        raise ValueError(
            f"{where}: string option value {value!r} would re-parse as "
            f"{_parse_value(value)!r}; pick a non-literal name")
    return value


def render_opts(opts: Mapping) -> str:
    """Canonical `[k=v,...]` suffix (sorted keys; empty -> no brackets)."""
    if not opts:
        return ""
    inner = ",".join(f"{k}={render_value(v)}" for k, v in sorted(opts.items()))
    return f"[{inner}]"


def parse_item(item: str) -> tuple[str, dict]:
    """Parse one `name` / `name[k=v,flag,...]` item into (name, opts).

    A bare option inside brackets is a boolean flag (`cuda[planes]`
    == `cuda[planes=true]`). Raises ValueError on malformed input.
    """
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
# Pass registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PassDef:
    """One registered pass: its callable, its declared options (spec opt
    name -> (python type, callable keyword)), and a one-liner."""
    name: str
    fn: Callable
    opts: tuple = ()            # ((opt_name, type, fn_keyword), ...)
    doc: str = ""

    def keyword_for(self, opt: str) -> str:
        for o, _, kw in self.opts:
            if o == opt:
                return kw
        raise KeyError(opt)

    def opt_for_keyword(self, kw: str) -> str | None:
        for o, _, k in self.opts:
            if k == kw:
                return o
        return None


_PASS_REGISTRY: dict[str, PassDef] = {}
_FN_TO_DEF: dict[Callable, PassDef] = {}
_PIPELINES: dict[str, str] = {}


def register_pass(passdef: PassDef) -> PassDef:
    _PASS_REGISTRY[passdef.name] = passdef
    _FN_TO_DEF[passdef.fn] = passdef
    return passdef


def register_pipeline(name: str, spec: str) -> None:
    """Name a full spec string (resolvable via `PipelineSpec.coerce`)."""
    PipelineSpec.parse(spec)  # validate eagerly
    _PIPELINES[name] = spec


def list_passes() -> tuple[PassDef, ...]:
    return tuple(_PASS_REGISTRY[k] for k in sorted(_PASS_REGISTRY))


def list_pipelines() -> dict[str, str]:
    return dict(_PIPELINES)


register_pass(PassDef(
    name="zeros", fn=_passes.delete_zero_terms,
    doc="drop 0*x addends (paper L4, per-term)"))
register_pass(PassDef(
    name="prune", fn=_passes.prune_dead_units,
    doc="remove structurally dead hidden units (paper L4, per-unit)"))
register_pass(PassDef(
    name="addends", fn=_passes.addend_rewrite,
    doc="expand w*x into |w| unit addends (paper L5, mult-free)"))
register_pass(PassDef(
    name="cse", fn=_passes.share_common_addends,
    opts=(("budget", int, "max_new_nodes"), ("bucketed", bool, "bucketed")),
    doc="share repeated addend pairs (adder CSE; irregular DAG)"))


def _resolve_dotted(name: str) -> Callable:
    mod, _, attr = name.rpartition(".")
    try:
        fn = getattr(importlib.import_module(mod), attr)
    except (ImportError, AttributeError) as e:
        raise ValueError(
            f"unknown pass {name!r}: not in the registry "
            f"({', '.join(sorted(_PASS_REGISTRY))}) and not importable "
            f"({e})") from None
    if not callable(fn):
        raise ValueError(f"pass {name!r} resolves to non-callable {fn!r}")
    return fn


# ---------------------------------------------------------------------------
# PipelineSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PassSpec:
    """One pipeline step in canonical form: registry (or dotted) name plus
    a sorted tuple of (opt, value) pairs."""
    name: str
    opts: tuple = ()

    def item_string(self) -> str:
        return f"{self.name}{render_opts(dict(self.opts))}"


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A declarative, fingerprintable pass pipeline. See module doc."""
    steps: tuple[PassSpec, ...]

    # -- construction --------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "PipelineSpec":
        """Parse a comma list of `name[opts]` items. Unknown passes,
        malformed bracket options, unknown options, ill-typed option
        values, and duplicate steps all raise ValueError."""
        if not isinstance(spec, str):
            raise TypeError(f"PipelineSpec.parse takes a string, got {spec!r}")
        steps: list[PassSpec] = []
        seen: set[str] = set()
        # comma-split at bracket depth 0 only (opts may contain commas)
        depth = 0
        merged: list[str] = []
        for part in spec.split(","):
            if depth > 0:
                merged[-1] += "," + part
            else:
                merged.append(part)
            depth += part.count("[") - part.count("]")
        if depth != 0:
            raise ValueError(f"malformed spec {spec!r}: unbalanced brackets")
        items = [m.strip() for m in merged]
        if not items or any(not m for m in items):
            raise ValueError(
                f"empty item in pipeline spec {spec!r} (a spec is a comma "
                "list of pass names, e.g. 'zeros,prune')")
        for item in items:
            name, raw_opts = parse_item(item)
            name = _canonical_pass_name(name)
            opts = _validate_pass_opts(name, raw_opts)
            if name in seen:
                raise ValueError(
                    f"duplicate pass {name!r} in spec {spec!r} (each pass "
                    "may appear once; rewrites are applied in order)")
            seen.add(name)
            steps.append(PassSpec(name=name, opts=opts))
        return cls(steps=tuple(steps))

    @classmethod
    def named(cls, name: str) -> "PipelineSpec":
        """Resolve a registered pipeline name ("default", "hw")."""
        if name not in _PIPELINES:
            raise ValueError(
                f"unknown pipeline {name!r} (registered: "
                f"{', '.join(sorted(_PIPELINES))})")
        return cls.parse(_PIPELINES[name])

    @classmethod
    def from_passes(cls, passes: Sequence[Callable]) -> "PipelineSpec":
        """Represent a sequence of pass callables (registered functions,
        `functools.partial` of them, or callables produced by `build()`)
        as a spec. Lambdas/closures and unknown partial keywords raise —
        they have no stable canonical form."""
        steps = tuple(_spec_for_callable(p) for p in passes)
        names = [s.name for s in steps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate passes in pipeline: {names}")
        return cls(steps=steps)

    @classmethod
    def coerce(cls, value) -> "PipelineSpec":
        """The one entry point every API uses: None -> the "default"
        pipeline; a PipelineSpec -> itself; a string -> named pipeline or
        parsed spec; a sequence of callables -> `from_passes`."""
        if value is None:
            return cls.named("default")
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            if value in _PIPELINES:
                return cls.named(value)
            return cls.parse(value)
        if callable(value):
            return cls.from_passes([value])
        return cls.from_passes(list(value))

    # -- canonical form ------------------------------------------------------

    def spec_string(self) -> str:
        """The canonical string; `parse(spec_string())` is the identity."""
        return ",".join(s.item_string() for s in self.steps)

    def fingerprint(self) -> str:
        """sha256 of the canonical spec string (version-tagged)."""
        h = hashlib.sha256()
        h.update(f"{_FINGERPRINT_TAG}:{self.spec_string()}".encode())
        return h.hexdigest()

    def __str__(self) -> str:
        return self.spec_string()

    # -- execution -----------------------------------------------------------

    def build(self) -> tuple[Callable, ...]:
        """Materialize the pipeline as `Circuit -> Circuit` callables.
        Each carries its canonical item string as `__name__` (so
        `PassStats.name` reads e.g. `cse[bucketed=true,budget=8]`) and a
        `_pass_spec` attribute for exact round-tripping."""
        return tuple(_build_step(step) for step in self.steps)

    def run(self, circuit: Circuit, *, observe=None,
            verify: bool | None = None
            ) -> tuple[Circuit, tuple[PassStats, ...]]:
        """Apply the pipeline, recording per-pass stats. `observe`, if
        given, is called as observe(stage_name, circuit) for the lowered
        circuit and after every pass (the cost target's pass trace).
        With tracing enabled each pass runs under a `netgen.pass` span
        (nested in `netgen.pipeline`) carrying its before/after node
        and term counts.

        `verify=True` checks the full `analysis` invariant suite at
        every pass boundary — structural well-formedness, the pass's own
        postconditions, accumulator range proofs, and that no pass
        *widened* a class score's value interval (an exact rewrite may
        only tighten it). A violation raises `analysis.VerificationError`
        naming the pass and the node, and counts
        `netgen_verify_failures_total{phase=pipeline}`. `verify=None`
        (default) takes the
        `NETGEN_VERIFY` env var: on in tests, off in production (the
        Session driver still runs one pre-backend analysis regardless)."""
        from repro_torch.netgen import analysis

        check = analysis.strict_verify() if verify is None else bool(verify)
        tel = telemetry.get_registry()
        with tel.span("netgen.pipeline", pipeline=self.spec_string(),
                      steps=len(self.steps)):
            if observe is not None:
                observe("lowered", circuit)
            envelope = None
            if check:
                analysis.verify_circuit(circuit, stage="lowered")
                envelope = analysis.analyze_ranges(
                    circuit).output_envelope(circuit)
            stats = []
            for step, fn in zip(self.steps, self.build()):
                before = ops(circuit)
                stage = step.item_string()
                with tel.span("netgen.pass", name=stage) as sp:
                    circuit = fn(circuit)
                    after = ops(circuit)
                    sp.set_attr("terms_before", before.terms)
                    sp.set_attr("terms_after", after.terms)
                    sp.set_attr("nodes_deleted", before.nodes - after.nodes)
                stats.append(PassStats(name=stage, before=before, after=after))
                if check:
                    ranges, diags = analysis.analyze(
                        circuit, after_pass=step.name, stage=stage,
                        collect=True)
                    if not diags:
                        nxt = ranges.output_envelope(circuit)
                        diags = analysis.check_envelope(
                            envelope, nxt, stage=stage, collect=True)
                        envelope = nxt
                    if diags:
                        tel.counter("netgen_verify_failures_total",
                                    phase="pipeline").inc(len(diags))
                        raise analysis.VerificationError(diags)
                if observe is not None:
                    observe(stage, circuit)
        return circuit, tuple(stats)


def _canonical_pass_name(name: str) -> str:
    if name in _PASS_REGISTRY:
        return name
    # full function names alias their registry entry
    for pd in _PASS_REGISTRY.values():
        if name == pd.fn.__name__:
            return pd.name
    if "." in name:
        _resolve_dotted(name)   # validates importability
        return name
    raise ValueError(
        f"unknown pass {name!r} (registered: "
        f"{', '.join(sorted(_PASS_REGISTRY))}; dotted module paths are "
        "also accepted)")


def _validate_pass_opts(name: str, raw_opts: dict) -> tuple:
    pd = _PASS_REGISTRY.get(name)
    if pd is None:             # dotted out-of-tree pass: opts pass through
        for k, v in raw_opts.items():
            if isinstance(v, str):
                check_opt_string(v, f"option {k!r} of pass {name!r}")
        return tuple(sorted(raw_opts.items()))
    declared = {o: t for o, t, _ in pd.opts}
    out = {}
    for k, v in raw_opts.items():
        if k not in declared:
            raise ValueError(
                f"unknown option {k!r} for pass {name!r} "
                f"(declared: {', '.join(sorted(declared)) or 'none'})")
        want = declared[k]
        if want is bool:
            if not isinstance(v, bool):
                raise ValueError(
                    f"option {k!r} of pass {name!r} wants true/false, "
                    f"got {v!r}")
        elif want is int:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(
                    f"option {k!r} of pass {name!r} wants an integer, "
                    f"got {v!r}")
        out[k] = v
    return tuple(sorted(out.items()))


def _build_step(step: PassSpec) -> Callable:
    pd = _PASS_REGISTRY.get(step.name)
    if pd is not None:
        fn = pd.fn
        kwargs = {pd.keyword_for(k): v for k, v in step.opts}
    else:
        fn = _resolve_dotted(step.name)
        kwargs = dict(step.opts)

    def run(circuit: Circuit) -> Circuit:
        return fn(circuit, **kwargs)

    label = step.item_string()
    run.__name__ = label
    run.__qualname__ = label
    run._pass_spec = step
    return run


def _spec_for_callable(p: Callable) -> PassSpec:
    spec = getattr(p, "_pass_spec", None)
    if spec is not None:
        return spec
    if isinstance(p, functools.partial):
        inner = _spec_for_callable(p.func)
        if p.args:
            raise ValueError(
                f"cannot represent positional partial args of {p!r} in a "
                "pipeline spec; bind options by keyword")
        pd = _PASS_REGISTRY.get(inner.name)
        opts = dict(inner.opts)
        for kw, v in p.keywords.items():
            opt = pd.opt_for_keyword(kw) if pd is not None else kw
            if opt is None:
                raise ValueError(
                    f"keyword {kw!r} of {p!r} has no declared option on "
                    f"pass {inner.name!r} — it cannot be fingerprinted")
            opts[opt] = v
        return PassSpec(name=inner.name,
                        opts=_validate_pass_opts(inner.name, opts))
    pd = _FN_TO_DEF.get(p)
    if pd is not None:
        return PassSpec(name=pd.name)
    name = getattr(p, "__qualname__", None) or getattr(p, "__name__", None)
    if not name or "<lambda>" in name or "<locals>" in name:
        raise ValueError(
            f"cannot represent pass {name or p!r} in a pipeline spec: "
            "lambdas and closures have no stable fingerprint — spell it as "
            "a registry entry (e.g. 'cse[budget=5]'), a module-level "
            "function, or functools.partial of one")
    mod = getattr(p, "__module__", None)
    if not mod:
        raise ValueError(f"cannot represent pass {name!r}: no module")
    dotted = f"{mod}.{name}"
    _resolve_dotted(dotted)    # must be re-importable to round-trip
    return PassSpec(name=dotted)


# Built-in named pipelines (registered last: registration parses eagerly).
register_pipeline("default", "zeros,prune")
register_pipeline("hw", "zeros,prune,addends,cse")
