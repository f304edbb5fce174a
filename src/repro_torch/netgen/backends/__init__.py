"""Backends, enumerated by the Target registry.

  torch    — dense masked-column-sum predictor (the oracle; `torch_ref.py`)
  cuda     — per-layer dense, packed and bit-plane kernel chains and the
             whole-net bit-plane megakernel (`cuda.py`)
  fused    — the 2-layer net in one kernel launch (`cuda.compile_fused`)
  verilog  — the paper's combinational module source, a string
             (`verilog.py`)
  cost     — IR walk -> logic-cell estimate vs the paper's Figure 7
             (`cost.py`)

The array backends compile through ONE lowering step,
`repro_torch.netgen.plan.lower_circuit`; `verilog` and `cost` walk the
circuit itself, so they also take the irregular DAGs that adder sharing
makes. `torch` and `cuda` offer a multi-net form (`compile_multi`): a
stacked ExecutionPlan becomes one (M, B, n_in) -> (M, B) dispatch, the
cross-model batching that `repro_torch.netgen.serve.NetServer` uses;
`fused` has none, so the server routes each version on its own.
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.netgen.backends.cost import (
    CellCounts, CostReport, compile_cost, logic_cells,
)
from repro_torch.netgen.backends.verilog import emit_verilog
from repro_torch.netgen.targets import resolve_target

__all__ = [
    "CellCounts", "CostReport", "compile_circuit", "compile_cost",
    "compile_multi", "emit_verilog", "logic_cells",
]


def compile_circuit(circuit, backend: str = "torch", *, device=None, **opts):
    """Compile an IR circuit with the named target. Extra options are
    target-specific (declared in the registry; e.g. module_name/style/
    addend for verilog, packed/planes for cuda). Callable targets build
    on `device`, resolved like every entry point (the card unless the
    caller passes "cpu"); host-only targets take no device."""
    target, merged = resolve_target(backend, opts)
    if target.callable:
        merged["device"] = resolve_device(device)
    return target.compile(circuit, **merged)


def compile_multi(plan, backend: str = "torch", *, device, **opts):
    """Compile a stacked ExecutionPlan into one multi-net dispatch:
    uint8 (M, B, n_in) -> predictions (M, B) on `device`. `backend`
    accepts bracket options like the single-net form; options are
    validated against the target's declaration. The plan is certified
    by `analysis.verify_plan` before any backend sees it (a violation
    raises `VerificationError`, a ValueError)."""
    from repro_torch.netgen import analysis
    target, merged = resolve_target(backend, opts)
    if target.compile_multi is None:
        raise ValueError(f"target {target.name!r} has no multi-net dispatch")
    analysis.verify_plan(plan, stage="compile_multi")
    return target.compile_multi(plan, device=device, **merged)
