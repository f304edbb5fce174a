"""Session API: compile once per content, persist artifacts across processes.

Counterpart of `repro/netgen/session.py`, without the kernel tuner and
the design-space explorer (later slices):

  compile_artifact — the full driver: frontend -> `PipelineSpec` ->
      range analysis -> `Target`, returning an `Artifact` that carries
      the optimized circuit, per-pass stats, the logic-cell estimate,
      the proof summary, host timings and its content address.

  ArtifactStore — a persistent, content-addressed artifact directory.
      The key is sha256 over the net's weights digest x
      `PipelineSpec.fingerprint()` x the canonical target string x a
      fingerprint of the port's compiler sources, so a SECOND process
      pointed at the same directory warm-starts: the optimized circuit
      is reloaded from flat integer arrays (`graph.circuit_to_arrays`,
      no pickle) and the predictor is rebuilt from it, on the device the
      reader names, without re-running the frontend or any pass. Writes
      are atomic (temp dir + rename), so processes can share one store.
      The layout (`meta.json`, `circuit.npz`, `artifact.txt`) is the
      reference's, field for field.

  Session — the object users hold: an in-memory tier (the serving
      layer's `CompileCache`) over an optional `ArtifactStore`, the
      device every callable artifact runs on, and a background compile
      queue.

      session = Session(store=ArtifactStore("~/.cache/netgen"))  # cuda:0
      art = session.compile(qnet, target="cuda[planes=true]")
      art(images)                   # int32 class ids on the card
      print(art.report())           # pass savings + cell estimate
      handle = session.compile_async(qnet2, target="cuda[planes=true]")
      ...                           # keep serving while it compiles
      handle.result()               # the Artifact, store now warm
      engine = session.engine(target="cuda[planes=true]")

`Session(device="cpu")` runs the kernels' plain versions on the CPU;
without it every entry point wants CUDA and raises when it is absent.
The `verilog` and `cost` targets are host-only: their artifacts are text
and a `CostReport`, and the device plays no part in them.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import io
import json
import os
import shutil
import threading
import time
import uuid
import weakref
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.quantize import weights_digest
from repro_torch.netgen import analysis as _analysis
from repro_torch.netgen import telemetry
from repro_torch.netgen.backends.cost import CellCounts, CostReport, logic_cells
from repro_torch.netgen.frontend import _extract_weights, lower
from repro_torch.netgen.graph import (
    Circuit, circuit_from_arrays, circuit_to_arrays,
)
from repro_torch.netgen.passes import CircuitOps, PassStats
from repro_torch.netgen.pipeline import PipelineSpec
from repro_torch.netgen.targets import resolve_target, target_string

__all__ = [
    "Artifact", "ArtifactStore", "Session", "StoreStats", "artifact_key",
    "compile_artifact", "compile_resolved",
]

_FORMAT = "netgen-artifact-v1"
_SOURCE_FINGERPRINT: str | None = None


def _source_fingerprint() -> str:
    """sha256 over the port's netgen sources (plus the quantize module
    that defines digest semantics), computed once per process. Folded
    into every artifact key so a store can NEVER serve circuits
    optimized by older compiler code — editing any pass or backend
    invalidates all persisted artifacts."""
    global _SOURCE_FINGERPRINT
    if _SOURCE_FINGERPRINT is None:
        h = hashlib.sha256()
        pkg = Path(__file__).parent
        files = sorted(pkg.rglob("*.py"))
        files.append(pkg.parent / "core" / "quantize.py")
        for f in files:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        _SOURCE_FINGERPRINT = h.hexdigest()
    return _SOURCE_FINGERPRINT


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
    """The store's content address: net digest x pipeline fingerprint x
    canonical target string x compiler source fingerprint, hashed. The
    source axis retires stale artifacts whenever the compiler itself
    changes (a spec string names WHICH passes run, not their
    implementation), so the port's keys differ from the reference's."""
    h = hashlib.sha256()
    h.update(f"{_FORMAT}:{_source_fingerprint()}:{digest}:"
             f"{spec.fingerprint()}:{target}".encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Artifact:
    """One compilation result, self-describing enough to persist.

    `artifact` is the target's product (a predictor, Verilog text or a
    `CostReport`), and `kind` says which ("callable", "text" or
    "report"). `cost` is the logic-cell estimate of the final circuit
    (every target gets one; the `cost` target's artifact additionally
    breaks it down per pass). `source` says where this object
    originated: "compile" (built in this process) or "store" (reloaded
    from disk); memory-tier hits return the same object. `analysis` is
    the range-analysis proof summary computed before the backend
    (`analysis.proof_summary`), and `timings` the host seconds of each
    compile stage (plus `load_s` for store loads and `cost_analysis`
    under profiling). For callable targets `plan_form` records which
    ExecutionPlan form the predictor executes ("dense", "packed" or
    "planes"), and `plan()` re-lowers the circuit into that form (what
    the serving layer stacks for multi-net dispatch)."""
    digest: str
    pipeline: str              # canonical PipelineSpec string
    target: str                # canonical target string (with options)
    kind: str                  # "callable" | "text" | "report"
    key: str                   # ArtifactStore content address
    circuit: Circuit
    pass_stats: tuple
    cost: CellCounts
    timings: dict
    source: str
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


# ---------------------------------------------------------------------------
# Compile driver
# ---------------------------------------------------------------------------

def compile_artifact(net, *, target="torch", pipeline=None,
                     input_threshold: int | None = None, device=None,
                     **target_opts) -> Artifact:
    """Frontend -> pipeline -> target, uncached. `net` is anything the
    frontend accepts; `pipeline` anything `PipelineSpec.coerce` accepts
    (None -> "default"); `target` a name or `name[opt=...]` string.
    Callable targets build on `device` (the card unless the caller
    passes "cpu"); host-only targets need none."""
    spec = PipelineSpec.coerce(pipeline)
    tgt, opts = resolve_target(target, target_opts)
    dev = resolve_device(device) if tgt.callable else None
    ws, thr = _extract_weights(net, input_threshold)
    return compile_resolved(ws, thr, weights_digest(ws, thr), spec, tgt,
                            opts, dev)


def compile_resolved(ws, thr: int, digest: str, spec: PipelineSpec,
                     tgt, opts: dict, device: torch.device | None
                     ) -> Artifact:
    """The compile driver proper, for callers (the cache tiers) that
    already extracted the weights and computed the digest. Records the
    pass trace for targets that want it, always runs the pre-backend
    range analysis (raising `VerificationError` under
    `analysis.strict_verify()`, otherwise counting
    `netgen_verify_failures_total{phase=compile}` and proceeding), and
    hands the analysis to targets that want it. Only callable targets
    receive `device`."""
    tstring = target_string(tgt, opts)
    tel = telemetry.get_registry()

    with tel.span("netgen.compile", target=tstring,
                  pipeline=spec.spec_string(), digest=digest[:12]):
        t0 = time.perf_counter()
        with tel.span("netgen.lower"):
            circuit = lower(ws, input_threshold=thr)
        t_lower = time.perf_counter()

        trace: list | None = [] if tgt.wants_pass_trace else None
        circuit, stats = spec.run(
            circuit, observe=(lambda name, c: trace.append((name, c)))
            if trace is not None else None)
        t_passes = time.perf_counter()

        # Prove every accumulator fits its inferred width (and int32)
        # before any backend bakes those widths into Verilog, cell counts
        # or kernel dtypes.
        with tel.span("netgen.analysis"):
            ranges, diags = _analysis.analyze(circuit, stage="pre-backend",
                                              collect=True)
            if diags:
                tel.counter("netgen_verify_failures_total",
                            phase="compile").inc(len(diags))
                if _analysis.strict_verify():
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
        with tel.span("netgen.backend", target=tstring):
            raw = tgt.compile(circuit, **kwargs)
        t_backend = time.perf_counter()

    tel.histogram("netgen_compile_seconds", target=tgt.name).observe(
        t_backend - t0)
    timings = {
        "lower_s": t_lower - t0,
        "passes_s": t_passes - t_lower,
        "analysis_s": t_analysis - t_passes,
        "backend_s": t_backend - t_analysis,
        "total_s": t_backend - t0,
    }
    plan_form = None
    if tgt.callable:
        plan_form = getattr(raw, "plan_form", None) or "dense"
        if tel.profile:
            # roofline inputs per compiled artifact at a canonical sample
            # batch; persisted with the timings in meta.json
            prof = telemetry.jit_cost(raw, (8, circuit.n_inputs))
            if prof is not None:
                timings["cost_analysis"] = prof
                tel.gauge("netgen_artifact_flops",
                          target=tgt.name).set(prof["flops"])
                tel.gauge("netgen_artifact_bytes",
                          target=tgt.name).set(prof["bytes_accessed"])
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
        source="compile",
        artifact=raw,
        plan_form=plan_form,
        analysis=summary,
    )


# ---------------------------------------------------------------------------
# Persistent store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StoreStats:
    """Point-in-time snapshot of one store's telemetry counters (the
    live values are atomic `telemetry.Counter`s labelled with the
    store's scope; this dataclass is the read API)."""
    saves: int = 0
    loads: int = 0          # get() found and rebuilt an artifact
    misses: int = 0         # get() found nothing under the key
    corrupt: int = 0        # unreadable entries evicted and re-missed
    gc_evictions: int = 0   # entries removed by gc() size/count bounds
    load_seconds: float = 0.0

    def row(self) -> str:
        return (f"store: {self.saves} saves, {self.loads} loads, "
                f"{self.misses} misses, {self.gc_evictions} gc evictions, "
                f"{self.load_seconds * 1e3:.1f} ms loading")


class ArtifactStore:
    """Content-addressed on-disk artifact directory (see module doc).

    Layout: `<root>/<key>/meta.json` (digest, pipeline, target, pass
    stats, cell estimate, timings, plan form, proof summary),
    `circuit.npz` (the optimized circuit as flat integer arrays), and
    `artifact.txt` for text targets. Callable artifacts are rebuilt
    from the stored circuit on load, on the device `get` is given — the
    frontend and every pass are skipped, which is where compile time
    lives. Puts are atomic; a key that already exists is left alone.

    Size bounds: `max_entries` / `max_bytes` cap the store; `gc()`
    evicts least-recently-used entries (by meta.json mtime, which
    `get()` refreshes on every successful load) until both bounds hold.
    `put()` runs gc automatically when a bound is configured. Unbounded
    by default.
    """

    def __init__(self, root, *, max_entries: int | None = None,
                 max_bytes: int | None = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.root = Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._tel = telemetry.get_registry()
        scope = telemetry.new_scope("store")
        self._c_saves = self._tel.counter(
            "netgen_store_saves_total", store=scope)
        self._c_loads = self._tel.counter(
            "netgen_store_loads_total", store=scope)
        self._c_misses = self._tel.counter(
            "netgen_store_misses_total", store=scope)
        self._c_corrupt = self._tel.counter(
            "netgen_store_corrupt_total", store=scope)
        self._c_gc = self._tel.counter(
            "netgen_store_gc_evictions_total", store=scope)
        self._h_load = self._tel.histogram(
            "netgen_store_load_seconds", store=scope)

    @property
    def stats(self) -> StoreStats:
        """Snapshot of the store's counters (atomic; safe to read while
        other threads load/put)."""
        return StoreStats(
            saves=int(self._c_saves.value),
            loads=int(self._c_loads.value),
            misses=int(self._c_misses.value),
            corrupt=int(self._c_corrupt.value),
            gc_evictions=int(self._c_gc.value),
            load_seconds=float(self._h_load.sum))

    def _dir(self, key: str) -> Path:
        return self.root / key

    def __contains__(self, key: str) -> bool:
        return (self._dir(key) / "meta.json").exists()

    def __len__(self) -> int:
        return len(self.keys())

    def keys(self) -> list[str]:
        return sorted(
            p.name for p in self.root.iterdir()
            if (p / "meta.json").exists())

    def put(self, artifact: Artifact) -> None:
        """Persist one artifact under its content address (atomic; a
        concurrent writer of the same key wins harmlessly)."""
        final = self._dir(artifact.key)
        if (final / "meta.json").exists():
            return
        tmp = self.root / f".tmp-{artifact.key[:16]}-{uuid.uuid4().hex[:8]}"
        tmp.mkdir()
        try:
            meta = {
                "format": _FORMAT,
                "digest": artifact.digest,
                "pipeline": artifact.pipeline,
                "target": artifact.target,
                "kind": artifact.kind,
                "pass_stats": [
                    {"name": s.name,
                     "before": s.before.as_dict(),
                     "after": s.after.as_dict()}
                    for s in artifact.pass_stats],
                "cost": artifact.cost.as_dict(),
                "timings": artifact.timings,
                "plan_form": artifact.plan_form,
                "analysis": artifact.analysis,
                "created_unix": time.time(),
            }
            if artifact.kind == "text":
                (tmp / "artifact.txt").write_text(artifact.artifact)
            elif artifact.kind == "report":
                meta["cost_report"] = artifact.artifact.as_dict()
            buf = io.BytesIO()
            np.savez_compressed(buf, **circuit_to_arrays(artifact.circuit))
            (tmp / "circuit.npz").write_bytes(buf.getvalue())
            with open(tmp / "meta.json", "w") as f:
                json.dump(meta, f, indent=1)
            try:
                os.rename(tmp, final)
            except OSError:
                if not (final / "meta.json").exists():
                    raise
                shutil.rmtree(tmp, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._c_saves.inc()
        if self.max_entries is not None or self.max_bytes is not None:
            self.gc()

    def gc(self) -> list[str]:
        """Evict least-recently-used entries until the configured
        size/count bounds hold; returns the evicted keys (oldest
        first). Recency is meta.json mtime — refreshed by `get()` —
        so a warm-started artifact outlives a never-reused one. A
        no-op (empty list) when no bound is configured."""
        if self.max_entries is None and self.max_bytes is None:
            return []
        entries = []                 # (mtime, key, bytes)
        for p in self.root.iterdir():
            if p.name.startswith(".tmp-"):
                continue             # an in-flight put(), not an entry
            meta = p / "meta.json"
            try:
                mtime = meta.stat().st_mtime
                size = sum(
                    f.stat().st_size for f in p.iterdir() if f.is_file())
            except OSError:
                continue             # concurrently evicted mid-scan
            entries.append((mtime, p.name, size))
        entries.sort()
        count = len(entries)
        total = sum(size for _, _, size in entries)
        evicted: list[str] = []
        while entries and (
                (self.max_entries is not None and count > self.max_entries)
                or (self.max_bytes is not None and total > self.max_bytes)):
            _, key, size = entries.pop(0)
            shutil.rmtree(self._dir(key), ignore_errors=True)
            evicted.append(key)
            count -= 1
            total -= size
        self._c_gc.inc(len(evicted))
        return evicted

    def get(self, key: str, *, device=None) -> Artifact | None:
        """Load and rebuild the artifact stored under `key` (None when
        absent). A callable entry is rebuilt from the stored circuit on
        `device`, resolved like every entry point: the card unless the
        caller passes "cpu", raising without CUDA before the circuit is
        read. Text and report entries need no device. A corrupt or
        unreadable entry (truncated JSON, bad npz, stale format) is
        treated as a miss and evicted from disk, so the caller falls
        back to a recompile whose `put` re-creates it."""
        d = self._dir(key)
        meta_path = d / "meta.json"
        if not meta_path.exists():
            self._c_misses.inc()
            return None
        t0 = time.perf_counter()
        with self._tel.span("netgen.store.load", key=key[:12]) as sp:
            meta = art = None
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                kind = meta["kind"]
            except Exception:
                pass
            else:
                dev = resolve_device(device) if kind == "callable" else None
                try:
                    art = self._load(d, key, meta, dev)
                except Exception:
                    meta = None
            if meta is None:
                shutil.rmtree(d, ignore_errors=True)
                self._c_corrupt.inc()
                self._c_misses.inc()
                sp.set_attr("outcome", "corrupt")
                return None
            sp.set_attr("outcome", "hit" if art is not None else "miss")
        if art is None:
            self._c_misses.inc()
            return None
        dt = time.perf_counter() - t0
        art.timings["load_s"] = dt
        self._c_loads.inc()
        self._h_load.observe(dt)
        try:
            os.utime(meta_path)      # refresh LRU recency for gc()
        except OSError:
            pass
        return art

    def _load(self, d: Path, key: str, meta: dict,
              device: torch.device | None) -> Artifact | None:
        if meta.get("format") != _FORMAT:
            return None
        with np.load(d / "circuit.npz") as z:
            circuit = circuit_from_arrays(z)
        tgt, opts = resolve_target(meta["target"])
        if meta["kind"] == "text":
            raw = (d / "artifact.txt").read_text()
        elif meta["kind"] == "report":
            raw = CostReport.from_dict(meta["cost_report"])
        else:
            raw = tgt.compile(circuit, device=device, **opts)
            meta["plan_form"] = getattr(raw, "plan_form",
                                        meta.get("plan_form"))
        stats = tuple(
            PassStats(name=s["name"],
                      before=CircuitOps(**s["before"]),
                      after=CircuitOps(**s["after"]))
            for s in meta["pass_stats"])
        cost = meta["cost"]
        return Artifact(
            digest=meta["digest"],
            pipeline=meta["pipeline"],
            target=meta["target"],
            kind=meta["kind"],
            key=key,
            circuit=circuit,
            pass_stats=stats,
            cost=CellCounts(
                **{k: v for k, v in cost.items() if k != "total"}),
            timings=dict(meta["timings"]),
            source="store",
            artifact=raw,
            plan_form=meta.get("plan_form"),
            analysis=meta.get("analysis"),
        )


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

def load_or_compile(store: "ArtifactStore | None", counters, device,
                    ws, thr: int, digest: str, spec: PipelineSpec, tgt,
                    opts: dict) -> tuple[Artifact, float | None]:
    """Resolve one compile-tier miss: the store when it holds the
    artifact, else a full compile that is then persisted. Updates
    `counters` (a `serve.CacheCounters`) so that every miss the caller
    counted lands in exactly one of store_hits, compiles or failures.
    Returns the artifact and its compile seconds (None from the store)."""
    try:
        if store is not None:
            art = store.get(artifact_key(digest, spec, target_string(tgt, opts)),
                            device=device)
            if art is not None:
                counters.store_hits.inc()
                counters.load_seconds.observe(art.timings.get("load_s", 0.0))
                return art, None
        t0 = time.perf_counter()
        art = compile_resolved(ws, thr, digest, spec, tgt, opts, device)
        dt = time.perf_counter() - t0
    except BaseException:
        counters.failures.inc()
        raise
    counters.compiles.inc()
    counters.compile_seconds.observe(dt)
    if store is not None:
        store.put(art)
    return art, dt


def _shutdown_executor(executor) -> None:
    """weakref.finalize callback — module-level so the finalizer holds
    no reference back to the Session (which would keep it alive)."""
    executor.shutdown(wait=True, cancel_futures=True)


class Session:
    """The compiler's stateful front door for one device: an in-memory
    LRU tier (the serving layer's `CompileCache`) over an optional
    persistent `ArtifactStore` (a path or a store), and a background
    compile queue (`compile_async`). `device` defaults to `cuda:0` and
    raises without CUDA; pass `device="cpu"` to run the plain versions
    on the CPU. `capacity=0` disables in-memory retention (every compile
    still reads/writes the store when one is configured).

    Sessions are context managers (`with Session(...) as s:`); exiting
    calls `shutdown()`. A session that is simply dropped is safe too:
    the async executor is tied to the object with a weakref finalizer,
    so its worker threads are joined at GC or interpreter exit."""

    def __init__(self, *, device=None, store=None, capacity: int = 64):
        from repro_torch.netgen.serve import CacheCounters, CompileCache
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.device = resolve_device(device)
        if store is not None and not isinstance(store, ArtifactStore):
            store = ArtifactStore(store)
        self.store = store
        self._executor = None
        self._executor_lock = threading.Lock()
        self._finalizer = None
        if capacity > 0:
            self.cache: "CompileCache | None" = CompileCache(
                capacity, store=store, device=self.device)
            self._counters = None
        else:
            self.cache = None
            self._counters = CacheCounters(telemetry.new_scope("session"))

    def compile(self, net, *, target="torch", pipeline="default",
                input_threshold: int | None = None,
                **target_opts) -> Artifact:
        """Compile `net` for `target` under `pipeline`, reusing the
        memory tier and the store when they already hold the artifact.
        Compiles of different keys run concurrently; concurrent requests
        for one key coalesce onto one compile."""
        if self.cache is not None:
            return self.cache.get_or_compile(
                net, backend=target, passes=pipeline,
                input_threshold=input_threshold, **target_opts)
        # uncached session: store tier only
        spec = PipelineSpec.coerce(pipeline)
        tgt, opts = resolve_target(target, target_opts)
        ws, thr = _extract_weights(net, input_threshold)
        self._counters.misses.inc()
        art, _ = load_or_compile(self.store, self._counters, self.device,
                                 ws, thr, weights_digest(ws, thr), spec,
                                 tgt, opts)
        return art

    def compile_async(self, net, *, target="torch", pipeline="default",
                      input_threshold: int | None = None, **target_opts):
        """Queue `compile` on the session's background executor and
        return a `concurrent.futures.Future` resolving to the Artifact.

        Kick off the expensive specializations early, keep serving, and
        by the time a `NetServer.register` asks for the same content it
        hits the warm memory tier (joining a compile still in flight)
        instead of starting a second one. Two workers named
        `netgen-compile`, tied to the session by a weakref finalizer."""
        with self._executor_lock:
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="netgen-compile")
                # the executor's workers are non-daemon threads; a caller
                # that forgets shutdown() must not hang (or leak threads
                # at) interpreter exit, so tie the executor's lifetime to
                # the Session object — weakref.finalize runs both at GC
                # and atexit
                self._finalizer = weakref.finalize(
                    self, _shutdown_executor, self._executor)
        return self._executor.submit(
            self.compile, net, target=target, pipeline=pipeline,
            input_threshold=input_threshold, **target_opts)

    def engine(self, *, target: str = "torch", pipeline=None,
               slot_capacity: int = 256, warmup: bool = True,
               max_batch_delay: float = 0.002, max_queue_depth: int = 4096):
        """Build an async online `ServingEngine` over this session: the
        engine's `NetServer` compiles through this session's memory tier
        and persistent store, on its device, so `register` warm-starts
        from artifacts a previous process (or a `compile_async` kicked
        off earlier) already produced. See `repro_torch.netgen.engine`."""
        from repro_torch.netgen.engine import ServingEngine

        return ServingEngine(
            session=self, target=target, pipeline=pipeline,
            slot_capacity=slot_capacity, warmup=warmup,
            max_batch_delay=max_batch_delay,
            max_queue_depth=max_queue_depth)

    def shutdown(self, wait: bool = True) -> None:
        """Stop the async compile executor (idempotent; queued compiles
        finish when `wait`)."""
        with self._executor_lock:
            executor, self._executor = self._executor, None
            finalizer, self._finalizer = self._finalizer, None
        if finalizer is not None:
            finalizer.detach()
        if executor is not None:
            executor.shutdown(wait=wait)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.shutdown()

    def stats(self):
        """Hit/miss/compile counters (`serve.CacheStats`; the memory
        tier's when one exists)."""
        if self.cache is not None:
            return self.cache.stats()
        return self._counters.snapshot()

    def store_stats(self) -> StoreStats | None:
        return None if self.store is None else self.store.stats
