"""netgen on PyTorch: the paper's net-to-hardware compiler, served on a GPU.

Counterpart of `repro.netgen`. A `QuantizedNet` is lowered to the
circuit IR (`frontend.lower`), optimized by a `PipelineSpec` (default
`zeros,prune`; `hw` = `zeros,prune,addends,cse`), range-checked by
`analysis`, and compiled for a target:

    torch                dense masked-column-sum oracle (JAX: `jnp`)
    cuda                 per-layer dense kernel chain (JAX: `pallas`)
    cuda[packed=true]    per-layer chain over bit-packed activations
    cuda[planes=true]    per-layer bit-plane kernel chain
    cuda[fusednet=true]  the whole planes-form net in one kernel launch
    fused                the 2-layer paper net in one kernel launch
    verilog              the paper's clockless combinational module (text)
    cost                 logic-cell estimate vs the paper's Figure 7

The array targets take the regular layered form only; the adder-sharing
pass (`cse`) makes an irregular DAG that only `verilog`, `cost` and the
numpy interpreter `graph.evaluate` accept (the array targets raise
`IrregularCircuitError`).

`Session` holds the compiled artifacts for one device (the card unless
`device="cpu"`), and `NetServer` serves registered versions, stacking
compatible ones into one multi-net dispatch and recording a
`StackReport` for sets that cannot stack.
"""
from repro_torch.netgen import analysis, backends
from repro_torch.netgen.analysis import (
    Diagnostic, RangeAnalysis, StackReport, VerificationError,
    analyze_ranges, diagnose_stack, verify_circuit, verify_plan,
)
from repro_torch.netgen.backends.cost import CellCounts, CostReport
from repro_torch.netgen.frontend import lower
from repro_torch.netgen.graph import (
    Argmax, Circuit, InputCompare, IrregularCircuitError, SignStep, Term,
    WeightedSum, as_layered_weights, circuit_from_arrays, circuit_to_arrays,
    evaluate, node_widths,
)
from repro_torch.netgen.passes import (
    DEFAULT_PASSES, HW_PASSES, CircuitOps, Pass, PassStats, addend_rewrite,
    delete_zero_terms, ops, prune_dead_units, run_pipeline,
    share_common_addends,
)
from repro_torch.netgen.pipeline import (
    PipelineSpec, list_passes, list_pipelines, register_pass,
    register_pipeline,
)
from repro_torch.netgen.plan import (
    ExecutionPlan, MegakernelView, PlanLayer, decompose_planes,
    lower_circuit, stack_plans,
)
from repro_torch.netgen.serve import NetServer
from repro_torch.netgen.session import Artifact, Session
from repro_torch.netgen.targets import (
    Target, list_targets, register_target, resolve_target,
)

__all__ = [
    "Argmax", "Artifact", "CellCounts", "Circuit", "CircuitOps",
    "CostReport", "DEFAULT_PASSES", "Diagnostic", "ExecutionPlan",
    "HW_PASSES", "InputCompare", "IrregularCircuitError", "MegakernelView",
    "NetServer", "Pass", "PassStats", "PipelineSpec", "PlanLayer",
    "RangeAnalysis", "Session", "SignStep", "StackReport", "Target", "Term",
    "VerificationError", "WeightedSum", "addend_rewrite", "analysis",
    "analyze_ranges", "as_layered_weights", "backends",
    "circuit_from_arrays", "circuit_to_arrays", "decompose_planes",
    "delete_zero_terms", "diagnose_stack", "evaluate", "list_passes",
    "list_pipelines", "list_targets", "lower", "lower_circuit",
    "node_widths", "ops", "prune_dead_units", "register_pass",
    "register_pipeline", "register_target", "resolve_target",
    "run_pipeline", "share_common_addends", "stack_plans",
    "verify_circuit", "verify_plan",
]
