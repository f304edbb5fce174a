"""Multi-version serving of netgen-compiled predictors.

Counterpart of `repro/netgen/serve.py`'s `NetServer`, without mesh
sharding and telemetry (later slices):

  NetServer — serve uint8 image batches across registered model
      versions. Single-version requests route to that version's
      `Artifact` in fixed-capacity slot rounds. Multi-version requests
      stack compatible versions' ExecutionPlans along a model axis
      (`repro_torch.netgen.plan.stack_plans`) and serve them with one
      multi-net dispatch per round (the target's `compile_multi`); for
      `cuda[planes=true]` / `cuda[fusednet=true]` that is ONE
      `binary_forward_planes` launch for every version and layer, for
      `cuda` and `cuda[packed=true]` the per-layer chain looped over the
      versions. Incompatible sets, and targets without a multi-net form
      (`fused`), fall back to per-version routing, and the reason is
      recorded as an `analysis.StackReport` (`stack_report()`).
      `dispatch_counts` records which path served each request.

Hidden-width padding used for stacking is exact: a zero-padded column is
an empty accumulator, step(0) = 0, and its outgoing row is zero-padded
too. Predictions come back as numpy arrays on the host.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.netgen import analysis
from repro_torch.netgen.backends import compile_multi
from repro_torch.netgen.graph import IrregularCircuitError
from repro_torch.netgen.plan import lower_circuit, stack_plans
from repro_torch.netgen.session import Artifact, Session, _validate_batch
from repro_torch.netgen.targets import resolve_target
from repro_torch.serve.slots import pad_slots

__all__ = ["NetServer"]


def _to_host(preds) -> np.ndarray:
    """Predictions as a host numpy array (a CUDA tensor is copied back)."""
    if isinstance(preds, torch.Tensor):
        return preds.cpu().numpy()
    return np.asarray(preds)


@dataclasses.dataclass
class _Version:
    name: str
    compiled: Artifact


class NetServer:
    """Serve uint8 image batches across registered model versions.

    `session=` compiles through that `Session` (its memory tier and its
    device); without one the server makes a `Session()` on the default
    device. `target=`/`pipeline=` select what to compile; the target
    must produce a callable artifact.
    """

    def __init__(self, *, session: Session | None = None,
                 target: str | None = None, pipeline=None,
                 slot_capacity: int = 256, warmup: bool = True):
        self._target, self._opts = resolve_target(
            target if target is not None else "torch")
        if not self._target.callable:
            raise ValueError(
                f"NetServer needs a callable target, got {target!r} "
                f"(kind: {self._target.kind})")
        if slot_capacity < 1:
            raise ValueError(f"slot_capacity must be >= 1, got {slot_capacity}")
        self.session = session if session is not None else Session()
        self.device = self.session.device
        self.backend = self._target.name
        self.pipeline = pipeline
        self.slot_capacity = int(slot_capacity)
        self.warmup = bool(warmup)
        self._lock = threading.RLock()
        self._versions: "OrderedDict[str, _Version]" = OrderedDict()
        self._multi: dict[tuple, object] = {}
        # why a version set could not stack: {names: analysis.StackReport}
        self._stack_reports: dict[tuple, analysis.StackReport] = {}
        self._generation = 0   # bumped by register/unregister; guards _multi
        self._dispatch = {"single": 0, "stacked": 0, "fallback": 0}

    @property
    def dispatch_counts(self) -> dict:
        """Per-path dispatch counts as a plain dict snapshot."""
        with self._lock:
            return dict(self._dispatch)

    def _count(self, path: str) -> None:
        with self._lock:
            self._dispatch[path] += 1

    # -- registry ------------------------------------------------------------

    def register(self, version: str, net) -> Artifact:
        """Compile (through the session) and register a model version.
        With `warmup`, the serving shape runs once BEFORE the version is
        published, so no request meets a cold predictor."""
        compiled = self.session.compile(
            net, target=self.backend, pipeline=self.pipeline, **self._opts)
        if self.warmup:
            z = np.zeros((self.slot_capacity, compiled.circuit.n_inputs),
                         np.uint8)
            _to_host(compiled(z))
        with self._lock:
            self._versions[version] = _Version(version, compiled)
            self._multi.clear()
            self._stack_reports.clear()
            self._generation += 1
        return compiled

    def unregister(self, version: str) -> None:
        with self._lock:
            del self._versions[version]
            self._multi.clear()
            self._stack_reports.clear()
            self._generation += 1

    def stack_report(self, names=None):
        """Why a version set fell back to per-version dispatch: the
        `analysis.StackReport` recorded when `_stacked_fn` diagnosed the
        set (None for sets that stacked fine or were never requested).
        With `names`, the report for that version set; without,
        {version-name tuple: report} for every diagnosed set."""
        with self._lock:
            if names is None:
                return dict(self._stack_reports)
            return self._stack_reports.get(tuple(sorted(names)))

    def versions(self) -> list[str]:
        with self._lock:
            return list(self._versions)

    def compiled_for(self, version: str) -> Artifact:
        with self._lock:
            v = self._versions.get(version)
        if v is None:
            raise KeyError(
                f"unknown version {version!r} (registered: {self.versions()})")
        return v.compiled

    # -- serving -------------------------------------------------------------

    def predict(self, version: str, x_uint8) -> np.ndarray:
        """Route one batch to one version. Returns predictions (B,)."""
        compiled = self.compiled_for(version)
        self._count("single")
        return self._run_slots(compiled, np.asarray(x_uint8))

    def predict_many(self, requests: dict) -> dict:
        """Serve {version: uint8 batch} in one cross-model stacked dispatch
        when the requested versions are stack-compatible (else per-version
        fallback). Returns {version: predictions}.

        Each slot round dispatches only the versions that still have
        requested rows, and the last remaining version finishes through
        the single-version slot path."""
        names = tuple(sorted(requests))
        compiled = {v: self.compiled_for(v) for v in names}
        xs = {v: np.asarray(requests[v]) for v in names}
        for v in names:
            _validate_batch(xs[v], compiled[v].circuit.n_inputs)
        if len(names) == 1:
            (v,) = names
            self._count("single")
            return {v: self._run_slots(compiled[v], xs[v])}

        fn = self._stacked_fn(names)
        if fn is None:
            self._count("fallback")
            return {v: self._run_slots(compiled[v], xs[v]) for v in names}

        self._count("stacked")
        cap = self.slot_capacity
        rounds = max((x.shape[0] + cap - 1) // cap for x in xs.values())
        out: dict[str, list] = {v: [] for v in names}
        for r in range(rounds):
            active = tuple(v for v in names if xs[v].shape[0] > r * cap)
            if len(active) == 1:
                (v,) = active
                out[v].append(self._run_slots(compiled[v], xs[v][r * cap:]))
                break
            # a strict subset of a stackable set is itself stackable; its
            # multi-net fn is cached in _multi like the full set's
            afn = fn if active == names else self._stacked_fn(active)
            chunks = [xs[v][r * cap:(r + 1) * cap] for v in active]
            preds, valid = self._stacked_round(afn, chunks)
            for i, v in enumerate(active):
                out[v].append(preds[i, :valid[i]])
        return {v: (np.concatenate(out[v]) if out[v]
                    else np.zeros((0,), np.int64)) for v in names}

    # -- internals -----------------------------------------------------------

    def _stacked_round(self, fn, chunks: list) -> tuple[np.ndarray, list]:
        """ONE stacked dispatch round: pad each version's chunk into the
        (M, cap, n_in) slot block and run the multi-net fn. Returns the
        (M, cap) predictions on the host and the per-version valid row
        counts."""
        cap = self.slot_capacity
        block = np.zeros((len(chunks), cap, chunks[0].shape[1]), np.uint8)
        valid = []
        for i, chunk in enumerate(chunks):
            block[i], n = pad_slots(chunk, cap)
            valid.append(n)
        return _to_host(fn(block)), valid

    def _run_slots(self, compiled: Artifact, x: np.ndarray) -> np.ndarray:
        _validate_batch(x, compiled.circuit.n_inputs)
        cap = self.slot_capacity
        if x.shape[0] == 0:
            return np.zeros((0,), np.int64)
        outs = []
        for i in range(0, x.shape[0], cap):
            padded, n = pad_slots(x[i:i + cap], cap)
            outs.append(_to_host(compiled(padded))[:n])
        return np.concatenate(outs)

    def _stacked_fn(self, names: tuple):
        """Build (or recall) the multi-net dispatch for this version set;
        None when the set cannot be stacked, with the reason recorded as
        a `StackReport` (the static `analysis.diagnose_stack`, or the
        build error when compilation itself fails). Compilation happens
        outside the lock; a generation check before storing keeps a stale
        build (a concurrent register/unregister) out of `_multi`."""
        while True:
            with self._lock:
                if names in self._multi:
                    return self._multi[names]
                generation = self._generation
                circuits = [self._versions[v].compiled.circuit for v in names]
            fn = None
            if self._target.compile_multi is None:
                report = analysis.StackReport(
                    compatible=False, n_versions=len(names),
                    diagnostics=(analysis.Diagnostic(
                        check="stack.target",
                        message=f"target {self._target.name!r} has no "
                                "multi-net dispatch"),))
            else:
                report = analysis.diagnose_stack(circuits)
                if report.compatible:
                    try:
                        plan = stack_plans(
                            [lower_circuit(c) for c in circuits])
                        fn = compile_multi(plan, backend=self._target.name,
                                           device=self.device, **self._opts)
                        report = None
                    except (IrregularCircuitError, ValueError) as e:
                        report = analysis.StackReport(
                            compatible=False, n_versions=len(names),
                            diagnostics=(analysis.Diagnostic(
                                check="stack.build", message=str(e)),))
            with self._lock:
                if self._generation == generation:
                    self._multi[names] = fn
                    if report is not None:
                        self._stack_reports[names] = report
                    return fn
            # registry changed underneath the build: retry
