"""Session API: compile a net once per content, for one device.

Counterpart of `repro/netgen/session.py`, without the persistent
`ArtifactStore`, the tuner and the explorer (later slices):

  compile_resolved — the driver: frontend -> `PipelineSpec` -> `Target`,
      returning an `Artifact` that carries the optimized circuit,
      per-pass stats and its content address.

  Session — the object users hold: an LRU in-memory tier keyed by the
      net's weights digest x the canonical pipeline x the canonical
      target string, and the device every artifact runs on.

      session = Session()                      # cuda:0; raises without CUDA
      art = session.compile(qnet, target="cuda")   # or "cuda[packed=true]",
                                               # "cuda[planes=true]", "fused"
      art(images)                              # int32 class ids on the card

`Session(device="cpu")` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.quantize import weights_digest
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
    """One compilation result. `artifact` is the target's predictor;
    `plan_form` records which ExecutionPlan form it executes ("dense",
    "packed" or "planes") and `plan()` re-lowers the circuit into that form (what
    the serving layer stacks for multi-net dispatch)."""
    digest: str
    pipeline: str              # canonical PipelineSpec string
    target: str                # canonical target string (with options)
    key: str                   # content address
    circuit: Circuit
    pass_stats: tuple
    artifact: object
    plan_form: str | None = None

    def plan(self):
        from repro_torch.netgen.plan import lower_circuit
        return lower_circuit(self.circuit, form=self.plan_form or "dense")

    def __call__(self, x_uint8) -> torch.Tensor:
        _validate_batch(x_uint8, self.circuit.n_inputs)
        return self.artifact(x_uint8)


def compile_resolved(ws, thr: int, digest: str, spec: PipelineSpec,
                     tgt, opts: dict, device: torch.device) -> Artifact:
    """The compile driver proper, for callers that already extracted the
    weights and computed the digest."""
    tstring = target_string(tgt, opts)
    circuit, stats = spec.run(lower(ws, input_threshold=thr))
    raw = tgt.compile(circuit, device=device, **opts)
    return Artifact(
        digest=digest,
        pipeline=spec.spec_string(),
        target=tstring,
        key=artifact_key(digest, spec, tstring),
        circuit=circuit,
        pass_stats=stats,
        artifact=raw,
        plan_form=getattr(raw, "plan_form", None) or "dense",
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
