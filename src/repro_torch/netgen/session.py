"""Session API: compile a net once per content, for one device.

Counterpart of `repro/netgen/session.py`, without the persistent
`ArtifactStore`, telemetry, the tuner and the explorer (later slices):

  compile_resolved — the driver: frontend -> `PipelineSpec` -> range
      analysis -> `Target`, returning an `Artifact` that carries the
      optimized circuit, per-pass stats, the logic-cell estimate, the
      proof summary, host timings and its content address.

  Session — the object users hold: an LRU in-memory tier keyed by the
      net's weights digest x the canonical pipeline x the canonical
      target string, and the device every callable artifact runs on.

      session = Session()                      # cuda:0; raises without CUDA
      art = session.compile(qnet, target="cuda")   # or "cuda[packed=true]",
                                               # "cuda[planes=true]", "fused"
      art(images)                              # int32 class ids on the card
      session.compile(qnet, target="verilog", pipeline="zeros,prune,addends")
      session.compile(qnet, target="cost").artifact.report()

`Session(device="cpu")` runs the kernels' plain versions on the CPU.
The `verilog` and `cost` targets are host-only: their artifacts are text
and a `CostReport`, and the device plays no part in them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.quantize import weights_digest
from repro_torch.netgen import analysis as _analysis
from repro_torch.netgen.backends.cost import CellCounts, logic_cells
from repro_torch.netgen.frontend import _extract_weights, lower
from repro_torch.netgen.graph import Circuit
from repro_torch.netgen.pipeline import PipelineSpec
from repro_torch.netgen.targets import resolve_target, target_string

__all__ = [
    "Artifact", "Session", "SessionStats", "artifact_key", "compile_resolved",
]

_FORMAT = "netgen-artifact-v1"


def _validate_batch(x, n_inputs: int) -> None:
    """Reject non-uint8 or wrongly-shaped predictor input with a clear
    error instead of silently mis-binarizing (a float image batch would
    compare scaled values against the integer pixel threshold)."""
    dtype = getattr(x, "dtype", None)
    ok = dtype == torch.uint8 if isinstance(x, torch.Tensor) else (
        dtype is not None and np.dtype(dtype) == np.uint8)
    if not ok:
        raise TypeError(
            f"compiled predictors take raw uint8 images, got dtype={dtype!r} "
            "(binarization happens inside the circuit; do not pre-scale)")
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) != 2 or shape[1] != n_inputs:
        raise ValueError(
            f"expected a (batch, {n_inputs}) uint8 image batch, "
            f"got shape {shape}")


def artifact_key(digest: str, spec: PipelineSpec, target: str) -> str:
    """Content address: net digest x pipeline fingerprint x canonical
    target string, hashed."""
    h = hashlib.sha256()
    h.update(f"{_FORMAT}:{digest}:{spec.fingerprint()}:{target}".encode())
    return h.hexdigest()


@dataclasses.dataclass
class Artifact:
    """One compilation result.

    `artifact` is the target's product (a predictor, Verilog text or a
    `CostReport`), and `kind` says which ("callable", "text" or
    "report"). `cost` is the logic-cell estimate of the final circuit
    (every target gets one; the `cost` target's artifact additionally
    breaks it down per pass). `analysis` is the range-analysis proof
    summary computed before the backend (`analysis.proof_summary`), and
    `timings` the host seconds of each compile stage (lower, passes,
    analysis, backend). For callable targets `plan_form` records which
    ExecutionPlan form the predictor executes ("dense", "packed" or
    "planes"), and `plan()` re-lowers the circuit into that form (what
    the serving layer stacks for multi-net dispatch)."""
    digest: str
    pipeline: str              # canonical PipelineSpec string
    target: str                # canonical target string (with options)
    kind: str                  # "callable" | "text" | "report"
    key: str                   # content address
    circuit: Circuit
    pass_stats: tuple
    cost: CellCounts
    timings: dict
    artifact: object
    plan_form: str | None = None
    analysis: dict | None = None

    @property
    def backend(self) -> str:
        """Base target name."""
        return self.target.partition("[")[0]

    def plan(self):
        if self.kind != "callable":
            raise TypeError(
                f"{self.backend} artifacts have no execution plan "
                f"(kind: {self.kind})")
        from repro_torch.netgen.plan import lower_circuit
        return lower_circuit(self.circuit, form=self.plan_form or "dense")

    def __call__(self, x_uint8) -> torch.Tensor:
        if not callable(self.artifact):
            raise TypeError(
                f"{self.backend} artifact is not callable (use .artifact)")
        _validate_batch(x_uint8, self.circuit.n_inputs)
        return self.artifact(x_uint8)

    def report(self) -> str:
        """Per-pass savings table, the final cell estimate, and the
        range-analysis proof summary when one was recorded."""
        lines = [s.row() for s in self.pass_stats]
        lines.append(self.cost.row())
        if self.analysis:
            lines.append(_analysis.summary_row(self.analysis))
        return "\n".join(lines)


def compile_resolved(ws, thr: int, digest: str, spec: PipelineSpec,
                     tgt, opts: dict, device: torch.device) -> Artifact:
    """The compile driver proper, for callers that already extracted the
    weights and computed the digest. Records the pass trace for targets
    that want it, always runs the pre-backend range analysis (raising
    `VerificationError` under `analysis.strict_verify()`, otherwise
    proceeding), and hands the analysis to targets that want it. Only
    callable targets receive `device`."""
    tstring = target_string(tgt, opts)
    t0 = time.perf_counter()
    circuit = lower(ws, input_threshold=thr)
    t_lower = time.perf_counter()

    trace: list | None = [] if tgt.wants_pass_trace else None
    circuit, stats = spec.run(
        circuit, observe=(lambda name, c: trace.append((name, c)))
        if trace is not None else None)
    t_passes = time.perf_counter()

    # Prove every accumulator fits its inferred width (and int32) before
    # any backend bakes those widths into Verilog, cell counts or kernel
    # dtypes. Strict mode (NETGEN_VERIFY, on in tests) raises on a
    # violation; production compiles anyway, as the reference does.
    ranges, diags = _analysis.analyze(circuit, stage="pre-backend",
                                      collect=True)
    if diags and _analysis.strict_verify():
        raise _analysis.VerificationError(diags)
    summary = _analysis.proof_summary(circuit, ranges)
    t_analysis = time.perf_counter()

    kwargs = dict(opts)
    if tgt.callable:
        kwargs["device"] = device
    if tgt.wants_pass_trace:
        kwargs["_pass_trace"] = tuple(trace)
    if tgt.wants_analysis:
        kwargs["_analysis"] = ranges
    raw = tgt.compile(circuit, **kwargs)
    t_backend = time.perf_counter()

    timings = {
        "lower_s": t_lower - t0,
        "passes_s": t_passes - t_lower,
        "analysis_s": t_analysis - t_passes,
        "backend_s": t_backend - t_analysis,
        "total_s": t_backend - t0,
    }
    return Artifact(
        digest=digest,
        pipeline=spec.spec_string(),
        target=tstring,
        kind=tgt.kind,
        key=artifact_key(digest, spec, tstring),
        circuit=circuit,
        pass_stats=stats,
        cost=logic_cells(circuit, analysis=ranges),
        timings=timings,
        artifact=raw,
        plan_form=(getattr(raw, "plan_form", None) or "dense")
        if tgt.callable else None,
        analysis=summary,
    )


@dataclasses.dataclass
class SessionStats:
    hits: int = 0
    misses: int = 0            # every miss compiles
    evictions: int = 0

    @property
    def compiles(self) -> int:
        return self.misses


class Session:
    """The compiler's front door for one device: an LRU in-memory tier
    keyed by digest x pipeline x target (`capacity=0` keeps nothing).
    `device` defaults to `cuda:0` and raises without CUDA; pass
    `device="cpu"` to run the plain versions on the CPU."""

    def __init__(self, *, device=None, capacity: int = 64):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Artifact]" = OrderedDict()
        self._stats = SessionStats()

    def compile(self, net, *, target="torch", pipeline="default",
                input_threshold: int | None = None,
                **target_opts) -> Artifact:
        """Compile `net` for `target` under `pipeline`, reusing the memory
        tier when it already holds the artifact. Compiles run under the
        session's lock, so concurrent requests for one key compile once."""
        spec = PipelineSpec.coerce(pipeline)
        tgt, opts = resolve_target(target, target_opts)
        ws, thr = _extract_weights(net, input_threshold)
        digest = weights_digest(ws, thr)
        key = artifact_key(digest, spec, target_string(tgt, opts))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self._stats.hits += 1
                return hit
            self._stats.misses += 1
            art = compile_resolved(ws, thr, digest, spec, tgt, opts,
                                   self.device)
            if self.capacity:
                self._entries[key] = art
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self._stats.evictions += 1
            return art

    def stats(self) -> SessionStats:
        with self._lock:
            return dataclasses.replace(self._stats)
