"""Execution backends, enumerated by the Target registry.

  torch  — dense masked-column-sum predictor (the oracle; `torch_ref.py`)
  cuda   — per-layer dense, packed and bit-plane kernel chains and the
           whole-net bit-plane megakernel (`cuda.py`)
  fused  — the 2-layer net in one kernel launch (`cuda.compile_fused`)

All compile through ONE lowering step,
`repro_torch.netgen.plan.lower_circuit`. `torch` and `cuda` offer a
multi-net form (`compile_multi`): a stacked ExecutionPlan becomes one
(M, B, n_in) -> (M, B) dispatch, the cross-model batching that
`repro_torch.netgen.serve.NetServer` uses; `fused` has none, so the
server routes each version on its own.
"""
from __future__ import annotations

from repro_torch.netgen.targets import resolve_target

__all__ = ["compile_multi"]


def compile_multi(plan, backend: str = "torch", *, device, **opts):
    """Compile a stacked ExecutionPlan into one multi-net dispatch:
    uint8 (M, B, n_in) -> predictions (M, B) on `device`. `backend`
    accepts bracket options like the single-net form; options are
    validated against the target's declaration."""
    target, merged = resolve_target(backend, opts)
    if target.compile_multi is None:
        raise ValueError(f"target {target.name!r} has no multi-net dispatch")
    return target.compile_multi(plan, device=device, **merged)
