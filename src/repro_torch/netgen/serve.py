"""Compile-cache serving of netgen-compiled predictors.

Counterpart of `repro/netgen/serve.py`:

  CompileCache — the in-memory tier of the Session API, for one device.
      The key is the sha256 digest of the quantized weights + input
      threshold (`repro_torch.core.quantize.weights_digest`) crossed
      with the canonical `PipelineSpec` and `Target` strings. A hit
      returns the *same* `Artifact` object that was compiled before; a
      miss consults the optional persistent `ArtifactStore` (so a
      second process warm-starts without recompiling), then compiles on
      the cache's device, records wall-clock compile time, persists, and
      LRU-evicts past a fixed capacity. Thread-safe: the lock covers
      lookup/insert only, a per-key in-flight event coalesces concurrent
      requests for the same key onto one compile, and compiles on
      unrelated keys never block each other (no head-of-line blocking).

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
      recorded as an `analysis.StackReport` (`stack_report()`) and
      counted in `netgen_stack_incompat_total{server,reason}`.
      `dispatch_counts` (backed by `netgen_dispatch_total{server,path}`)
      records which path served each request; every slot round is a
      `netgen.kernel` span that closes after the answers reach the host.

  Under a mesh with a data axis (`parallel.sharding.use_mesh`) the
      stacked dispatch is sharded over the slot dimension
      (`_shard_stacked`): each rank of the data axes serves cap / n_data
      slot rows of every version, and an `all_gather` over the data axes
      assembles the whole answer on every rank. "sharded" counts beside
      "stacked", not instead of it. The multi-net builds are cached per
      (version set, mesh), so leaving the mesh serves the single-device
      build again.

Hidden-width padding used for stacking is exact: a zero-padded column is
an empty accumulator, step(0) = 0, and its outgoing row is zero-padded
too. Predictions come back as numpy arrays on the host.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.core.quantize import weights_digest
from repro_torch.netgen import analysis, telemetry
from repro_torch.netgen.backends import compile_multi
from repro_torch.netgen.frontend import _extract_weights
from repro_torch.netgen.graph import Circuit, IrregularCircuitError
from repro_torch.netgen.pipeline import PipelineSpec
from repro_torch.netgen.plan import lower_circuit, stack_plans
from repro_torch.netgen.session import (
    Artifact, ArtifactStore, _validate_batch, load_or_compile,
)
from repro_torch.netgen.targets import resolve_target
from repro_torch.parallel.sharding import active_mesh
from repro_torch.serve.slots import pad_slots

# DEFAULT_CACHE is left out: a star import would make it, and it wants
# the card
__all__ = [
    "CacheCounters", "CacheKey", "CacheStats", "CompileCache", "NetServer",
    "cached_compile_net", "stack_layered_weights",
]


def _to_host(preds) -> np.ndarray:
    """Predictions as a host numpy array (a CUDA tensor is copied back)."""
    if isinstance(preds, torch.Tensor):
        return preds.cpu().numpy()
    return np.asarray(preds)


# ---------------------------------------------------------------------------
# Content-addressed compile cache
# ---------------------------------------------------------------------------

def _pass_fingerprint(p) -> str:
    """Canonical spec item for one pass callable (registry name plus
    bracketed options, e.g. `cse[budget=2]`). `functools.partial` of a
    registered pass maps its bound keywords back to declared options, so
    a budgeted variant does not alias the unbudgeted one. Lambdas and
    closures are refused (by `PipelineSpec.from_passes`)."""
    return PipelineSpec.from_passes([p]).spec_string()


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """What a compiled predictor is a function of: weight content digest,
    target name, canonical pipeline spec, and target options."""
    digest: str
    backend: str
    passes: str
    opts: tuple


@dataclasses.dataclass
class CacheStats:
    """Point-in-time snapshot of a compile tier's counters (see
    `CacheCounters` for the live, atomic backing metrics)."""
    hits: int = 0              # memory-tier hits
    misses: int = 0            # memory-tier misses (store hit OR compile)
    evictions: int = 0
    compile_seconds: float = 0.0   # total wall-clock spent compiling
    compiles: int = 0          # actual full compilations
    store_hits: int = 0        # misses served by the persistent store
    load_seconds: float = 0.0  # wall-clock spent loading from the store
    failures: int = 0          # misses whose compile raised (verify/backend)

    def row(self) -> str:
        return (f"cache: {self.hits} hits, {self.misses} misses "
                f"({self.store_hits} from store, {self.failures} failed), "
                f"{self.evictions} evictions, "
                f"{self.compile_seconds * 1e3:.1f} ms compiling, "
                f"{self.load_seconds * 1e3:.1f} ms loading")


class CacheCounters:
    """The live telemetry metrics behind one compile tier's `CacheStats`
    — atomic `telemetry.Counter`s plus two duration histograms, labelled
    with a process-unique `cache=` scope so two tiers never merge in the
    shared registry. `CompileCache` and the uncached `Session` path both
    mutate these; `snapshot()` is the dataclass read API. The counting
    identity misses == compiles + store_hits + failures holds per scope
    (`benchmarks/check_trace.py` gates it)."""

    __slots__ = ("scope", "hits", "misses", "evictions", "compiles",
                 "store_hits", "failures", "compile_seconds", "load_seconds")

    def __init__(self, scope: str | None = None,
                 registry: "telemetry.Registry | None" = None):
        tel = registry if registry is not None else telemetry.get_registry()
        self.scope = scope if scope is not None else telemetry.new_scope(
            "cache")
        self.hits = tel.counter("netgen_cache_hits_total", cache=self.scope)
        self.misses = tel.counter(
            "netgen_cache_misses_total", cache=self.scope)
        self.evictions = tel.counter(
            "netgen_cache_evictions_total", cache=self.scope)
        self.compiles = tel.counter(
            "netgen_cache_compiles_total", cache=self.scope)
        self.store_hits = tel.counter(
            "netgen_cache_store_hits_total", cache=self.scope)
        self.failures = tel.counter(
            "netgen_cache_compile_failures_total", cache=self.scope)
        self.compile_seconds = tel.histogram(
            "netgen_cache_compile_seconds", cache=self.scope)
        self.load_seconds = tel.histogram(
            "netgen_cache_load_seconds", cache=self.scope)

    def snapshot(self) -> CacheStats:
        return CacheStats(
            hits=int(self.hits.value),
            misses=int(self.misses.value),
            evictions=int(self.evictions.value),
            compiles=int(self.compiles.value),
            store_hits=int(self.store_hits.value),
            failures=int(self.failures.value),
            compile_seconds=float(self.compile_seconds.sum),
            load_seconds=float(self.load_seconds.sum))


class _InFlight:
    """One in-progress compile: waiters block on the event instead of on
    the cache lock, so a cold compile of key A never serializes hits (or
    other compiles) on unrelated keys behind it."""

    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: BaseException | None = None


class CompileCache:
    """LRU-bounded, thread-safe, content-addressed compile cache for one
    device — the in-memory tier over an optional persistent
    `ArtifactStore`. `device` defaults to `cuda:0` and raises without
    CUDA; every compile and store load through the cache builds there.

    Compiles run OUTSIDE the cache lock: the lock covers only lookup and
    insert, while a per-key in-flight event makes concurrent requests
    for the same key coalesce onto one compile (the first caller owns
    it, later ones join it). Requests for other keys proceed
    concurrently — a cold compile cannot head-of-line-block a hit on an
    unrelated key, which matters once an engine registers versions
    while it serves."""

    def __init__(self, capacity: int = 32, store: ArtifactStore | None = None,
                 *, device=None, tuner=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.store = store
        self.tuner = tuner       # forwarded to wants_tuner target compiles
        self._lock = threading.RLock()
        self._entries: "OrderedDict[CacheKey, Artifact]" = OrderedDict()
        self._inflight: dict[CacheKey, _InFlight] = {}
        self._compile_seconds: dict[CacheKey, float] = {}
        self._counters = CacheCounters()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> list[CacheKey]:
        with self._lock:
            return list(self._entries)

    def stats(self) -> CacheStats:
        """Snapshot of the hit/miss/eviction counters (atomic; safe to
        read while other threads compile)."""
        return self._counters.snapshot()

    def compile_seconds(self, key: CacheKey) -> float | None:
        """Recorded compile time of a resident entry (None if evicted)."""
        with self._lock:
            return self._compile_seconds.get(key)

    def _resolve(self, net, backend, passes, input_threshold, backend_opts):
        ws, thr = _extract_weights(net, input_threshold)
        spec = PipelineSpec.coerce(passes)
        tgt, opts = resolve_target(backend, backend_opts)
        key = CacheKey(
            digest=weights_digest(ws, thr),
            backend=tgt.name,
            passes=spec.spec_string(),
            opts=tuple(sorted(opts.items())),
        )
        return key, spec, tgt, opts, ws, thr

    def key_for(self, net, *, backend: str = "torch",
                passes=None, input_threshold: int | None = None,
                **backend_opts) -> CacheKey:
        """The content-addressed key `get_or_compile` would use. `passes`
        accepts a PipelineSpec, a spec/registry string, or a sequence of
        pass callables (see `_pass_fingerprint`)."""
        key, *_ = self._resolve(
            net, backend, passes, input_threshold, backend_opts)
        return key

    def get_or_compile(self, net, *, backend: str = "torch",
                       passes=None, input_threshold: int | None = None,
                       **backend_opts) -> Artifact:
        """Return the cached `Artifact` for this exact (weights, pipeline,
        target, options) combination — from memory, then the store, then
        by compiling (and persisting) on first sight anywhere."""
        key, spec, tgt, opts, ws, thr = self._resolve(
            net, backend, passes, input_threshold, backend_opts)
        while True:
            owner = False
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None:
                    self._entries.move_to_end(key)
                    self._counters.hits.inc()
                    return hit
                flight = self._inflight.get(key)
                if flight is None:
                    flight = self._inflight[key] = _InFlight()
                    self._counters.misses.inc()   # this call owns the miss
                    owner = True
            if owner:
                return self._compile_owner(
                    key, flight, spec, tgt, opts, ws, thr)
            # joiner: block until the owner resolves this key, then
            # re-check the table (a hit in the common case — counted as
            # one; an immediate eviction falls through to a fresh miss)
            flight.event.wait()
            if flight.error is not None:
                raise flight.error

    def _compile_owner(self, key, flight, spec, tgt, opts, ws, thr):
        """Resolve one miss outside the lock: store lookup, then a full
        compile; publish into the table and release the waiters."""
        try:
            compiled, dt = load_or_compile(
                self.store, self._counters, self.device, ws, thr,
                key.digest, spec, tgt, opts, tuner=self.tuner)
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
            flight.error = e
            flight.event.set()
            raise
        with self._lock:
            self._entries[key] = compiled
            if dt is not None:
                self._compile_seconds[key] = dt
            self._inflight.pop(key, None)
            while len(self._entries) > self.capacity:
                evicted, _ = self._entries.popitem(last=False)
                self._compile_seconds.pop(evicted, None)
                self._counters.evictions.inc()
        flight.event.set()
        return compiled


_DEFAULT_CACHE: CompileCache | None = None
_DEFAULT_CACHE_LOCK = threading.Lock()


def _default_cache() -> CompileCache:
    global _DEFAULT_CACHE
    with _DEFAULT_CACHE_LOCK:
        if _DEFAULT_CACHE is None:
            _DEFAULT_CACHE = CompileCache(capacity=64)
        return _DEFAULT_CACHE


def __getattr__(name: str):
    # DEFAULT_CACHE is made on first use, on the default device (cuda:0),
    # so importing the module never needs a card
    if name == "DEFAULT_CACHE":
        return _default_cache()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def cached_compile_net(net, **kw) -> Artifact:
    """`compile_artifact` through the process-wide DEFAULT_CACHE (on the
    card; raises without CUDA)."""
    return _default_cache().get_or_compile(net, **kw)


# ---------------------------------------------------------------------------
# Cross-model weight stacking
# ---------------------------------------------------------------------------

def stack_layered_weights(circuits: Sequence[Circuit]
                          ) -> tuple[int, list[np.ndarray]]:
    """Stack M regular circuits' weight matrices for the multi-net
    targets: lower each circuit to its ExecutionPlan and join them with
    `repro_torch.netgen.plan.stack_plans` (which owns the compatibility
    checks and the exact hidden-width padding).

    Returns (input_threshold, [per-layer (M, fan_in, fan_out) int32]).
    Raises IrregularCircuitError for shared/CSE circuits (via
    `lower_circuit`) and ValueError for incompatible topologies.
    """
    if not circuits:
        raise ValueError("no circuits to stack")
    plan = stack_plans([lower_circuit(c) for c in circuits])
    return plan.input_threshold, [l.weights for l in plan.layers]


def _kernel_attrs(fn) -> dict:
    """The datapath attributes a `netgen.kernel` span carries when the
    predictor declares them (the cuda and fused builds do): `form` names
    the executed datapath and `launches` the kernel launches one
    dispatch performs — `benchmarks/check_trace.py` gates that every
    fusednet round records exactly one launch."""
    dp = getattr(fn, "datapath", None)
    if dp is None:
        return {}
    attrs = {"form": dp}
    launches = getattr(fn, "launches_per_call", None)
    if launches is not None:
        attrs["launches"] = launches
    return attrs


def _shard_stacked(fn, mesh, capacity: int, device: torch.device):
    """Wrap a stacked dispatch ((M, cap, n_in) -> (M, cap)) so that each
    rank of the mesh's data axes serves cap / n_data slot rows of every
    version and an `all_gather` over those axes assembles the (M, cap)
    answer. Returns None (the single-device build serves) when the mesh
    has no data axis or the capacity does not divide across it. The
    wrapper keeps `datapath`, `launches_per_call` and `plan_form`, which
    the kernel spans read (`_kernel_attrs`)."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not data_axes:
        return None
    n = mesh.size(data_axes)
    if capacity % n != 0:
        return None
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot shard a server on {device}")
    group = mesh.group(data_axes)
    rows = capacity // n
    lo = dist.get_rank(group) * rows

    def sharded(block):
        local = fn(block[:, lo:lo + rows]).contiguous()        # (M, rows)
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts, dim=1)                          # (M, cap)

    for attr in ("datapath", "launches_per_call", "plan_form"):
        if hasattr(fn, attr):
            setattr(sharded, attr, getattr(fn, attr))
    sharded.sharded = True
    return sharded


# ---------------------------------------------------------------------------
# Multi-version server
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Version:
    name: str
    compiled: Artifact


class NetServer:
    """Serve uint8 image batches across registered model versions.

    Construction: `session=` compiles through that `Session`'s memory
    tier (which it requires), its store and its device; `cache=` through
    a `CompileCache`; with neither, the server makes a `CompileCache()`
    on the default device (the card; raises without CUDA).
    `target=`/`pipeline=` select what to compile; the target must
    produce a callable artifact. With `prefer_explored` (the default) a
    target that declares `explored` builds its stacked dispatch with
    `explored=true` unless the caller pinned it, so a design-space
    explorer's recorded winner serves the stacked rounds (inert without
    a record). Under a mesh with a data axis the stacked dispatch is
    sharded over the slot rows (see the module's docstring).
    """

    def __init__(self, *, session=None, target: str | None = None,
                 pipeline=None, cache: CompileCache | None = None,
                 slot_capacity: int = 256, warmup: bool = True,
                 prefer_explored: bool = True):
        self._target, self._opts = resolve_target(
            target if target is not None else "torch")
        if not self._target.callable:
            raise ValueError(
                f"NetServer needs a callable target, got {target!r} "
                f"(kind: {self._target.kind})")
        if slot_capacity < 1:
            raise ValueError(f"slot_capacity must be >= 1, got {slot_capacity}")
        if session is not None:
            if cache is not None:
                raise ValueError("pass session= or cache=, not both")
            if session.cache is None:
                raise ValueError(
                    "NetServer needs a Session with an in-memory tier "
                    "(capacity > 0)")
            self.cache = session.cache
        else:
            self.cache = cache if cache is not None else CompileCache()
        self.session = session
        self.device = self.cache.device
        # tuned=true stacked dispatch builds reuse the same persistent
        # tuning records as the single-version compiles
        self._tuner = self.cache.tuner
        self.prefer_explored = bool(prefer_explored) and \
            any(name == "explored" for name, _ in self._target.opts)
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
        self._tel = telemetry.get_registry()
        self._scope = telemetry.new_scope("server")
        self._dispatch = {
            path: self._tel.counter(
                "netgen_dispatch_total", server=self._scope, path=path)
            for path in ("single", "stacked", "sharded", "fallback")}
        self._h_occupancy = self._tel.histogram(
            "netgen_slot_occupancy", server=self._scope)

    @property
    def dispatch_counts(self) -> dict:
        """Per-path dispatch counts as a plain dict snapshot (the live
        values are atomic telemetry counters labelled with this
        server's scope)."""
        return {path: int(c.value) for path, c in self._dispatch.items()}

    def _latency(self, version: str):
        return self._tel.histogram(
            "netgen_predict_latency_seconds",
            server=self._scope, version=version)

    def _requests(self, version: str):
        """Per-version request counter: incremented exactly once per
        dispatch call per version, so every request has exactly one
        latency observation (`benchmarks/check_trace.py` gates it)."""
        return self._tel.counter(
            "netgen_requests_total", server=self._scope, version=version)

    # -- registry ------------------------------------------------------------

    def register(self, version: str, net) -> Artifact:
        """Compile (through the cache, and its store when one is
        configured) and register a model version. With `warmup`, the
        serving shape runs once BEFORE the version is published, so no
        request meets a cold predictor."""
        compiled = self.cache.get_or_compile(
            net, backend=self.backend, passes=self.pipeline, **self._opts)
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
        With `names`, the report for that version set under the active
        mesh; without, {version-name tuple: report} for every diagnosed
        set."""
        with self._lock:
            if names is None:
                return {k[0]: r for k, r in self._stack_reports.items()}
            return self._stack_reports.get((tuple(sorted(names)), active_mesh()))

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
        self._dispatch["single"].inc()
        t0 = time.perf_counter()
        with self._tel.span("netgen.dispatch", path="single",
                            versions=version):
            out = self._run_slots(compiled, np.asarray(x_uint8))
        self._requests(version).inc()
        self._latency(version).observe(time.perf_counter() - t0)
        return out

    def predict_many(self, requests: dict) -> dict:
        """Serve {version: uint8 batch} in one cross-model stacked dispatch
        when the requested versions are stack-compatible (else per-version
        fallback). Returns {version: predictions}.

        Each slot round dispatches only the versions that still have
        requested rows, and the last remaining version finishes through
        the single-version slot path. `netgen_predict_latency_seconds`
        records per-version SERVICE time — the rounds a version actually
        took part in."""
        t0 = time.perf_counter()
        names = tuple(sorted(requests))
        compiled = {v: self.compiled_for(v) for v in names}
        xs = {v: np.asarray(requests[v]) for v in names}
        for v in names:
            _validate_batch(xs[v], compiled[v].circuit.n_inputs)
        if len(names) == 1:
            (v,) = names
            self._dispatch["single"].inc()
            with self._tel.span("netgen.dispatch", path="single",
                                versions=v):
                out = {v: self._run_slots(compiled[v], xs[v])}
            self._requests(v).inc()
            self._latency(v).observe(time.perf_counter() - t0)
            return out

        fn = self._stacked_fn(names)
        if fn is None:
            self._dispatch["fallback"].inc()
            out = {}
            with self._tel.span("netgen.dispatch", path="fallback",
                                versions=len(names)):
                for v in names:
                    t1 = time.perf_counter()
                    out[v] = self._run_slots(compiled[v], xs[v])
                    self._requests(v).inc()
                    self._latency(v).observe(time.perf_counter() - t1)
            return out

        self._dispatch["stacked"].inc()
        sharded = getattr(fn, "sharded", False)
        if sharded:
            self._dispatch["sharded"].inc()
        cap = self.slot_capacity
        rounds = max((x.shape[0] + cap - 1) // cap for x in xs.values())
        out: dict[str, list] = {v: [] for v in names}
        service = {v: 0.0 for v in names}
        with self._tel.span("netgen.dispatch", path="sharded" if sharded else "stacked",
                            versions=len(names), rounds=rounds):
            for r in range(rounds):
                active = tuple(v for v in names if xs[v].shape[0] > r * cap)
                if len(active) == 1:
                    (v,) = active
                    t1 = time.perf_counter()
                    out[v].append(self._run_slots(
                        compiled[v], xs[v][r * cap:]))
                    service[v] += time.perf_counter() - t1
                    break
                # a strict subset of a stackable set is itself stackable;
                # its multi-net fn is cached in _multi like the full set's
                afn = fn if active == names else self._stacked_fn(active)
                chunks = [xs[v][r * cap:(r + 1) * cap] for v in active]
                t1 = time.perf_counter()
                preds, valid = self._stacked_round(afn, chunks, round=r)
                dt = time.perf_counter() - t1
                for i, v in enumerate(active):
                    out[v].append(preds[i, :valid[i]])
                    service[v] += dt
        for v in names:
            self._requests(v).inc()
            self._latency(v).observe(service[v])
        return {v: (np.concatenate(out[v]) if out[v]
                    else np.zeros((0,), np.int64)) for v in names}

    # -- internals -----------------------------------------------------------

    def _stacked_round(self, fn, chunks: list, round: int = 0
                       ) -> tuple[np.ndarray, list]:
        """ONE stacked dispatch round — the slot mechanics shared by
        `predict_many` and the async serving engine: pad each version's
        chunk into the (M, cap, n_in) slot block, observe occupancy over
        the slots actually requested, run the multi-net fn. Returns the
        (M, cap) predictions on the host and the per-version valid row
        counts."""
        cap = self.slot_capacity
        block = np.zeros((len(chunks), cap, chunks[0].shape[1]), np.uint8)
        valid = []
        for i, chunk in enumerate(chunks):
            block[i], n = pad_slots(chunk, cap)
            valid.append(n)
        self._h_occupancy.observe(sum(valid) / (len(chunks) * cap))
        attrs = {"round": round, "valid": sum(valid), **_kernel_attrs(fn)}
        with self._tel.span("netgen.kernel", **attrs):
            preds = _to_host(fn(block))                 # (M, cap)
        return preds, valid

    def _run_slots(self, compiled: Artifact, x: np.ndarray) -> np.ndarray:
        _validate_batch(x, compiled.circuit.n_inputs)
        cap = self.slot_capacity
        if x.shape[0] == 0:
            return np.zeros((0,), np.int64)
        attrs = _kernel_attrs(compiled.artifact)
        outs = []
        for i in range(0, x.shape[0], cap):
            padded, n = pad_slots(x[i:i + cap], cap)
            self._h_occupancy.observe(n / cap)
            with self._tel.span("netgen.kernel", valid=n, **attrs):
                outs.append(_to_host(compiled(padded))[:n])
        return np.concatenate(outs)

    def _stacked_fn(self, names: tuple):
        """Build (or recall) the multi-net dispatch for this version set;
        None when the set cannot be stacked, with the reason recorded as
        a `StackReport` (the static `analysis.diagnose_stack`, or the
        build error when compilation itself fails) and counted in
        `netgen_stack_incompat_total{server,reason}`. Under a mesh with
        a data axis the build is wrapped by `_shard_stacked`; builds are
        cached per (names, mesh), so leaving the mesh finds the
        single-device build. Compilation happens outside the lock; a
        generation check before storing keeps a stale build (a
        concurrent register/unregister) out of `_multi`."""
        mesh = active_mesh()
        key = (names, mesh)
        while True:
            with self._lock:
                if key in self._multi:
                    return self._multi[key]
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
                        opts = dict(self._opts)
                        if self.prefer_explored and "explored" not in opts:
                            opts["explored"] = True
                        fn = compile_multi(plan, backend=self._target.name,
                                           device=self.device,
                                           tuner=self._tuner, **opts)
                        if mesh is not None:
                            fn = _shard_stacked(fn, mesh, self.slot_capacity,
                                                self.device) or fn
                        report = None
                    except (IrregularCircuitError, ValueError) as e:
                        report = analysis.StackReport(
                            compatible=False, n_versions=len(names),
                            diagnostics=(analysis.Diagnostic(
                                check="stack.build", message=str(e)),))
            with self._lock:
                if self._generation == generation:
                    self._multi[key] = fn
                    if report is not None:
                        self._stack_reports[key] = report
                        self._tel.counter(
                            "netgen_stack_incompat_total",
                            server=self._scope, reason=report.reason).inc()
                    return fn
            # registry changed underneath the build: retry
