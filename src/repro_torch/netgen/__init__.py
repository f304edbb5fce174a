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

Pipelines are declarative strings (`"zeros,prune"`,
`"zeros,prune,addends,cse[budget=8,bucketed=true]"`), or sequences of
pass callables (`PipelineSpec.from_passes`: registered passes,
`functools.partial` of them, module-level functions by dotted name),
and fingerprint stably, as in the reference.

Compiling and serving, on the card unless the caller passes
`device="cpu"` (every entry point raises without CUDA otherwise):

    session = netgen.Session(store=netgen.ArtifactStore("./netgen-store"))
    art = session.compile(qnet, target="cuda[planes=true]")
    preds = art(images_uint8)            # int32 class ids on the card
    handle = session.compile_async(qnet2, target="cuda[planes=true]")
    with session.engine(target="cuda[planes=true]", slot_capacity=256,
                        max_batch_delay=0.002) as engine:
        engine.register("v1", qnet)      # memory tier, then store, then compile
        label = engine.submit("v1", image).result()

`Session` holds a `CompileCache` (the in-memory tier: LRU, thread-safe,
compiles outside its lock, concurrent requests for one key coalesced)
over an optional `ArtifactStore`, the persistent, content-addressed
tier: a second process pointed at the same directory warm-starts every
artifact with zero compiles, rebuilding the predictors on its own
device. `NetServer` serves registered versions in slot rounds, stacking
compatible ones into one multi-net dispatch and recording a
`StackReport` for sets that cannot stack; `ServingEngine`
(`repro_torch.netgen.engine`) is the async front door over it for
single requests, with continuous slot formation, a bounded queue,
deadlines and drain-on-exit. `python -m repro_torch.netgen.analysis
<store>` lints a store (`analysis.lint_store`).

Every layer reports into `telemetry` (`repro_torch.netgen.telemetry`),
a stdlib-only registry with the reference's metric names, label keys
and span names: counters, gauges and histograms (exact p50/p95/p99)
are always live; spans are recorded after `telemetry.enable()`;
`prometheus()`, `export_jsonl(path)`, `summary()` and `report()` export
them, and `benchmarks/check_trace.py` gates the port's traces as it
gates the reference's.

The old entry points stay: `compile_net` (deprecated, through
`default_session()`), `specialize`, `emit_verilog` (host-only: it needs
no device) and `repro_torch.core.netgen`.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.netgen import analysis, backends, telemetry
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
from repro_torch.netgen.session import (
    Artifact, ArtifactStore, Session, StoreStats, _validate_batch,
    compile_artifact,
)
from repro_torch.netgen.targets import (
    Target, list_targets, register_target, resolve_target,
)

__all__ = [
    "Argmax", "Artifact", "ArtifactStore", "CacheKey", "CellCounts",
    "Circuit", "CircuitOps", "CompileCache", "CompiledNet", "CostReport",
    "DEFAULT_PASSES", "DeadlineExceededError", "Diagnostic",
    "EngineClosedError", "EngineStats", "ExecutionPlan", "HW_PASSES",
    "InputCompare", "IrregularCircuitError", "MegakernelView", "NetServer",
    "Pass", "PassStats", "PipelineSpec", "PlanLayer", "QueueFullError",
    "RangeAnalysis", "ServingEngine", "Session", "SignStep", "StackReport",
    "StoreStats", "Target", "Term", "VerificationError", "WeightedSum",
    "addend_rewrite", "analysis", "analyze_ranges", "as_layered_weights",
    "backends", "cached_compile_net", "circuit_from_arrays",
    "circuit_to_arrays", "compile_artifact", "compile_net",
    "decompose_planes", "default_session", "delete_zero_terms",
    "diagnose_stack", "emit_verilog", "engine", "evaluate", "list_passes",
    "list_pipelines", "list_targets", "lower", "lower_circuit",
    "node_widths", "ops", "prune_dead_units", "register_pass",
    "register_pipeline", "register_target", "resolve_target",
    "run_pipeline", "serve", "share_common_addends", "specialize",
    "stack_layered_weights", "stack_plans", "telemetry", "verify_circuit",
    "verify_plan",
]


@dataclasses.dataclass(frozen=True)
class CompiledNet:
    """Result of one end-to-end compilation through the deprecated
    `compile_net` shim: the optimized circuit, the per-pass statistics,
    and the backend artifact (a predictor for torch/cuda/fused, the
    module source string for verilog). New code should hold the richer
    `Artifact` a `Session.compile` returns."""
    circuit: Circuit
    pass_stats: tuple[PassStats, ...]
    backend: str
    artifact: object

    def __call__(self, x_uint8):
        if not callable(self.artifact):
            raise TypeError(
                f"{self.backend} artifact is not callable (use .artifact)")
        _validate_batch(x_uint8, self.circuit.n_inputs)
        return self.artifact(x_uint8)

    def report(self) -> str:
        """Human-readable per-pass savings table."""
        return "\n".join(s.row() for s in self.pass_stats)


_DEFAULT_SESSION: Session | None = None


def default_session() -> Session:
    """The process-wide Session the deprecated entry points route
    through (memory tier only, on the default device: the card, raising
    without CUDA; configure your own Session for a persistent
    ArtifactStore or the CPU)."""
    global _DEFAULT_SESSION
    if _DEFAULT_SESSION is None:
        _DEFAULT_SESSION = Session(capacity=16)
    return _DEFAULT_SESSION


def compile_net(
    net,
    *,
    backend: str = "torch",
    passes=None,
    input_threshold: int | None = None,
    **backend_opts,
) -> CompiledNet:
    """Deprecated: use `Session.compile(net, target=..., pipeline=...)`.

    Kept as a thin shim routed through the default Session. `passes`
    accepts pass-callable sequences as well as PipelineSpec / spec
    strings; None means the "default" pipeline. Pass sequences a
    `PipelineSpec` cannot represent (closures, repeated passes) still
    compile — directly and uncached, on the default session's device.
    """
    warnings.warn(
        "netgen.compile_net is deprecated; use netgen.Session(...).compile("
        "net, target=..., pipeline=...) — see the repro_torch.netgen "
        "docstring", DeprecationWarning, stacklevel=2)
    try:
        spec = PipelineSpec.coerce(passes)
    except ValueError:
        # unrepresentable legacy pipeline: compile the old way (no cache)
        circuit = lower(net, input_threshold=input_threshold)
        circuit, stats = run_pipeline(circuit, passes)
        artifact = backends.compile_circuit(
            circuit, backend, device=default_session().device,
            **backend_opts)
        return CompiledNet(circuit=circuit, pass_stats=stats,
                           backend=backend.partition("[")[0],
                           artifact=artifact)
    art = default_session().compile(
        net, target=backend, pipeline=spec,
        input_threshold=input_threshold, **backend_opts)
    return CompiledNet(
        circuit=art.circuit, pass_stats=art.pass_stats,
        backend=art.backend, artifact=art.artifact)


def specialize(net, *, backend: str = "torch", passes=None, pipeline=None,
               **kw):
    """Compile and return just the predictor (old netgen name), through
    the default Session (on the card)."""
    return default_session().compile(
        net, target=backend,
        pipeline=pipeline if pipeline is not None else passes, **kw).artifact


def emit_verilog(net, *, addend: bool = True, module_name: str = "nn_inference",
                 passes=None) -> str:
    """Compile and return just the Verilog source (old netgen name).

    Matches the seed emitter's behavior: zero terms are always dropped at
    generation time; `addend=True` additionally applies the L5 rewrite.
    The verilog target is host-only, so this compiles without a session
    and needs no device.
    """
    if passes is None:
        passes = "zeros,addends" if addend else "zeros"
    return compile_artifact(
        net, target="verilog", pipeline=passes,
        module_name=module_name, addend=addend).artifact


# Serving layer (imported last: it builds on the session machinery).
from repro_torch.netgen import serve  # noqa: E402
from repro_torch.netgen.serve import (  # noqa: E402
    CacheKey, CompileCache, NetServer, cached_compile_net,
    stack_layered_weights,
)
from repro_torch.netgen import engine  # noqa: E402  (builds on serve)
from repro_torch.netgen.engine import (  # noqa: E402
    DeadlineExceededError, EngineClosedError, EngineStats, QueueFullError,
    ServingEngine,
)
