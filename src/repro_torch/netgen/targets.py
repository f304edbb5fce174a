"""Target registry: every execution backend as a first-class object.

Counterpart of `repro/netgen/targets.py`. Targets are addressed by the
same `name[opt=value,...]` item syntax as pipeline passes:

    torch                    dense masked-column-sum predictor (the oracle;
                             the counterpart of `jnp`)
    cuda                     per-layer dense kernel chain (the counterpart
                             of `pallas`)
    cuda[packed=true]        per-layer chain over bit-packed activations
    cuda[planes=true]        per-layer bit-plane kernel chain
    cuda[fusednet=true]      the whole planes-form net in one kernel launch
    cuda[tuned=true]         the datapath and block shapes searched per plan
                             shape and device kind, the winner persisted
    cuda[explored=true]      the design-space explorer's winner for the
                             plan shape, when one is recorded
    fused                    the 2-layer paper net in one kernel launch
                             (`fused[tuned=true]` searches its bm)
    verilog[style=legacy]    the paper's combinational module source (text)
    cost                     IR walk -> logic-cell estimate vs Figure 7

`resolve_target` parses an item string (or takes a bare name plus an
opts dict), validates options against the target's declaration, and
returns (Target, opts). `target_string` renders the canonical form.
`interpret`, which has no counterpart on the card, is undeclared, so it
raises "unknown option" like any other; `bkw` is declared on `cuda` so
that it raises the backend's own ValueError, which names the deviation
(no port kernel blocks K).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

from repro_torch.netgen.pipeline import (
    check_opt_string, parse_item, render_opts,
)

__all__ = [
    "Target", "get_target", "list_targets", "register_target",
    "resolve_target", "target_string",
]


@dataclasses.dataclass(frozen=True)
class Target:
    """One execution target. `compile` maps (circuit, **opts) to the
    artifact — callable targets also take `device=`; `kind` says what
    that artifact is ("callable", "text", "report"); `opts` declares the
    accepted options as (name, type) pairs; `compile_multi`, when
    present, builds the stacked multi-net dispatch (a stacked
    `ExecutionPlan` plus the same declared opts -> callable);
    `wants_pass_trace` asks the Session driver to hand the pipeline's
    per-pass circuit trace to `compile` as `_pass_trace`; and
    `wants_analysis` asks it to hand its pre-backend
    `analysis.RangeAnalysis` as `_analysis`, so width-consuming backends
    (verilog, cost) emit the proven widths instead of re-deriving
    them; `wants_tuner` asks every compile entry point (single and
    multi) to receive the caller's `repro_torch.netgen.tune.KernelTuner`
    as `_tuner` — how `Session(tune_store=...)` threads persisted tuning
    records into `tuned=true` kernel builds."""
    name: str
    kind: str
    description: str
    compile: Callable
    opts: tuple = ()                       # ((opt_name, type), ...)
    compile_multi: Callable | None = None
    wants_pass_trace: bool = False
    wants_analysis: bool = False
    wants_tuner: bool = False

    @property
    def callable(self) -> bool:
        return self.kind == "callable"


_REGISTRY: dict[str, Target] = {}


def register_target(target: Target) -> Target:
    _REGISTRY[target.name] = target
    return target


def get_target(name: str) -> Target:
    t = _REGISTRY.get(name)
    if t is None:
        raise ValueError(
            f"unknown target {name!r} (registered: "
            f"{', '.join(sorted(_REGISTRY))})")
    return t


def list_targets() -> tuple[Target, ...]:
    """Every registered target, sorted by name."""
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def resolve_target(target, extra_opts: Mapping | None = None
                   ) -> tuple[Target, dict]:
    """Resolve a target reference into (Target, validated opts).

    `target` is a Target, a bare name, or an item string with bracketed
    options ("cuda[planes=true]"); `extra_opts` are merged on top and
    validated the same way. Unknown targets, unknown options, and
    ill-typed option values raise ValueError.
    """
    if isinstance(target, Target):
        t, opts = target, {}
    else:
        name, opts = parse_item(str(target))
        t = get_target(name)
    merged = dict(opts)
    for k, v in (extra_opts or {}).items():
        if k in merged and merged[k] != v:
            raise ValueError(
                f"option {k!r} given twice for target {t.name!r}: "
                f"{merged[k]!r} in the target string vs {v!r} as a keyword")
        merged[k] = v
    declared = dict(t.opts)
    for k, v in merged.items():
        if k not in declared:
            raise ValueError(
                f"unknown option {k!r} for target {t.name!r} "
                f"(declared: {', '.join(sorted(declared)) or 'none'})")
        want = declared[k]
        if want is bool and not isinstance(v, bool):
            raise ValueError(
                f"option {k!r} of target {t.name!r} wants true/false, "
                f"got {v!r}")
        if want is int and (isinstance(v, bool) or not isinstance(v, int)):
            raise ValueError(
                f"option {k!r} of target {t.name!r} wants an integer, "
                f"got {v!r}")
        if want is str:
            if not isinstance(v, str):
                raise ValueError(
                    f"option {k!r} of target {t.name!r} wants a string, "
                    f"got {v!r}")
            check_opt_string(v, f"option {k!r} of target {t.name!r}")
    return t, merged


def target_string(target: Target, opts: Mapping) -> str:
    """Canonical `name[k=v,...]` form — one axis of the artifact key."""
    return f"{target.name}{render_opts(opts)}"


# ---------------------------------------------------------------------------
# Built-in targets (backend imports deferred to keep torch kernels off the
# parse path)
# ---------------------------------------------------------------------------

def _compile_torch(circuit, **opts):
    from repro_torch.netgen.backends.torch_ref import compile_torch
    return compile_torch(circuit, **opts)


def _compile_torch_multi(plan, **opts):
    from repro_torch.netgen.backends.torch_ref import compile_torch_multi
    return compile_torch_multi(plan, **opts)


def _compile_cuda(circuit, **opts):
    from repro_torch.netgen.backends.cuda import compile_cuda
    return compile_cuda(circuit, **opts)


def _compile_cuda_multi(plan, **opts):
    from repro_torch.netgen.backends.cuda import compile_cuda_multi
    return compile_cuda_multi(plan, **opts)


def _compile_fused(circuit, **opts):
    from repro_torch.netgen.backends.cuda import compile_fused
    return compile_fused(circuit, **opts)


def _compile_verilog(circuit, **opts):
    from repro_torch.netgen.backends.verilog import emit_verilog
    return emit_verilog(circuit, **opts)


def _compile_cost(circuit, **opts):
    from repro_torch.netgen.backends.cost import compile_cost
    return compile_cost(circuit, **opts)


register_target(Target(
    name="torch", kind="callable",
    description="dense masked-column-sum predictor (the oracle backend)",
    compile=_compile_torch, compile_multi=_compile_torch_multi))
register_target(Target(
    name="cuda", kind="callable",
    description="per-layer binary_matvec CUDA kernel chain: int8 "
                "activations into binary_matmul by default, packed=true "
                "chains bit-packed activations end to end "
                "(binary_matmul_packed), planes=true additionally splits "
                "weights into packed bit-planes accumulated by popcount "
                "(binary_matmul_planes), fusednet=true runs the whole "
                "planes-form net as ONE binary_forward_planes launch "
                "(stacked multi-net dispatch prefers it for planes=true "
                "too); bm/bn pin rows/columns per block; tuned=true "
                "grid-searches the form and the bm/bn block shapes per "
                "plan shape and device kind and persists the winner; "
                "explored=true resolves the design-space explorer's "
                "persisted winner for the plan shape when one exists, "
                "see Session.explore; bkw raises (no port kernel blocks K)",
    compile=_compile_cuda,
    opts=(("packed", bool), ("planes", bool), ("fusednet", bool),
          ("tuned", bool), ("explored", bool),
          ("bm", int), ("bn", int), ("bkw", int)),
    compile_multi=_compile_cuda_multi, wants_tuner=True))
register_target(Target(
    name="fused", kind="callable",
    description="single-launch whole-net CUDA kernel fused_mlp_predict "
                "(2-layer only; bm pins the rows per block, tuned=true "
                "searches it)",
    compile=_compile_fused,
    opts=(("tuned", bool), ("bm", int)),
    wants_tuner=True))
register_target(Target(
    name="verilog", kind="text",
    description="the paper's clockless combinational Verilog module",
    compile=_compile_verilog,
    opts=(("module_name", str), ("style", str), ("addend", bool)),
    wants_analysis=True))
register_target(Target(
    name="cost", kind="report",
    description="logic-cell estimate of the circuit vs paper Figure 7",
    compile=_compile_cost, wants_pass_trace=True, wants_analysis=True))
