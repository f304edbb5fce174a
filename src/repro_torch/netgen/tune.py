"""Persistent kernel autotuner: search tile parameters once, reuse forever.

Counterpart of `repro/netgen/tune.py`, with the same record format
(`netgen-tune-v1`), JSON layout, keying and metric names, so a record
written by either package's `TuneStore` reads back equal in the other.

Tile and loop parameters must be searched per workload, not hard-coded:
the port's kernels' block shapes (`bm`, `bn`) and the datapath form
(dense / packed / planes / fusednet) interact with the plan shape and
the device, so `cuda[tuned=true]` grid-searches them, and, because the
search is pure measurement over content-addressed inputs, the winner is
persisted and never re-measured:

  KernelTuner — the search driver. `get_or_tune(key_fields, candidates,
      measure)` consults an in-memory dict, then the persistent
      `TuneStore`, and only on a double miss times each candidate
      (best-of-`reps` host clock) and records the winner. `stats`
      counts hits / store hits / tunes / individual measurements, so a
      warm-started process can assert it measured nothing.

  TuneStore — one JSON file per record under a directory, addressed by
      sha256 over the canonical key fields (tune format version, target,
      device kind, plan signature, candidate grid). Writes are atomic
      (temp file + rename) so concurrent processes share a store the
      same way they share an `ArtifactStore`; corrupt entries degrade
      to a re-tune, never a failure.

  TuneRecord — the persisted artifact: the winning parameter dict plus
      every (candidate, microseconds) measurement, so the whole search
      surface can be read, not just the argmin.

The tuner is backend-agnostic: `backends/cuda.py` builds the candidate
list and the measure closure; this module owns keying, persistence and
the search loop. `Session(tune_store=...)` threads a shared tuner
through compiles, artifact-store reloads and the `NetServer`'s stacked
dispatch; without one, a process-wide in-memory tuner (`default_tuner`)
keeps `tuned=true` working, without cross-process reuse. The device
kind in a key is `device_kind(device)`: the CUDA device's name and
compute capability, or "cpu".
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import uuid
from pathlib import Path
from typing import Callable, Mapping, Sequence

from repro_torch.netgen import telemetry

__all__ = [
    "KernelTuner", "TuneRecord", "TuneStats", "TuneStore", "default_tuner",
    "device_kind", "tune_key",
]

_FORMAT = "netgen-tune-v1"


def device_kind(device) -> str:
    """The device identity tuning records are keyed on (the reference
    keys on `jax.devices()[0].device_kind`): a CUDA device's name plus
    its compute capability, e.g. "NVIDIA H100 80GB HBM3 sm_90", or
    "cpu"."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    return f"{torch.cuda.get_device_name(dev)} sm_{major}{minor}"


def tune_key(key_fields) -> str:
    """Content address of one tuning problem: sha256 over the canonical
    JSON of (format, *key_fields). Every field must be JSON-stable —
    shapes and names, not arrays — so the same problem keys identically
    across processes and machines of the same device kind."""
    blob = json.dumps([_FORMAT, key_fields], sort_keys=True,
                      separators=(",", ":"), default=_jsonify)
    return hashlib.sha256(blob.encode()).hexdigest()


def _jsonify(obj):
    if isinstance(obj, tuple):
        return list(obj)
    raise TypeError(f"tune key field {obj!r} is not JSON-stable")


@dataclasses.dataclass(frozen=True)
class TuneRecord:
    """One persisted search result: the problem's content address, the
    winning parameters, and the full measurement table (each candidate's
    best-of-reps wall clock in microseconds, search order preserved).

    `extra` carries driver-specific payload beyond the argmin — the
    design-space explorer stores its acceptance trace and prune log
    there so a warm start replays the whole report, not just the
    winner. Pre-`extra` records load with an empty dict."""
    key: str
    best: dict
    measurements: tuple          # ((params_dict, value), ...)
    device_kind: str
    created_unix: float
    extra: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "format": _FORMAT,
            "key": self.key,
            "best": self.best,
            "measurements": [[p, us] for p, us in self.measurements],
            "device_kind": self.device_kind,
            "created_unix": self.created_unix,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TuneRecord":
        return cls(
            key=d["key"],
            best=dict(d["best"]),
            measurements=tuple((dict(p), float(us))
                               for p, us in d["measurements"]),
            device_kind=d["device_kind"],
            created_unix=float(d["created_unix"]),
            extra=dict(d.get("extra") or {}),
        )


@dataclasses.dataclass
class TuneStats:
    """Point-in-time snapshot of one tuner's telemetry counters (the
    live values are atomic `telemetry.Counter`s under the tuner's
    scope; `KernelTuner.stats` builds this)."""
    hits: int = 0              # in-memory record reuse
    store_hits: int = 0        # records loaded from the persistent store
    tunes: int = 0             # full searches actually performed
    measurements: int = 0      # individual candidate timings taken
    rejected: int = 0          # candidates statically rejected, unmeasured
    measure_seconds: float = 0.0

    def row(self) -> str:
        return (f"tune: {self.hits} hits, {self.store_hits} store hits, "
                f"{self.tunes} tunes ({self.measurements} measurements, "
                f"{self.rejected} rejected, "
                f"{self.measure_seconds * 1e3:.1f} ms measuring)")


class TuneStore:
    """On-disk tuning records: `<root>/<key>.json`, atomic writes, a
    corrupt or stale-format entry reads as a miss and is evicted (a
    tuning cache must degrade to a re-tune, never fail the compile)."""

    def __init__(self, root):
        self.root = Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def __contains__(self, key: str) -> bool:
        return self._path(key).exists()

    def keys(self) -> list[str]:
        return sorted(p.stem for p in self.root.glob("*.json"))

    def get(self, key: str) -> TuneRecord | None:
        path = self._path(key)
        try:
            with open(path) as f:
                d = json.load(f)
            if d.get("format") != _FORMAT or d.get("key") != key:
                raise ValueError(f"stale tune record {key}")
            return TuneRecord.from_dict(d)
        except FileNotFoundError:
            return None
        except Exception:
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    def put(self, record: TuneRecord) -> None:
        tmp = self.root / f".tmp-{record.key[:16]}-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "w") as f:
                json.dump(record.as_dict(), f, indent=1)
            os.replace(tmp, self._path(record.key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


class KernelTuner:
    """Two-tier tuning cache + the grid-search driver (see module doc).

    Thread-safe: a tuner-wide lock guards the record tiers and stats,
    while searches measure under a per-key lock — concurrent callers of
    the same key search once, and a long search for one shape never
    blocks lookups or searches for other shapes.
    """

    def __init__(self, store: TuneStore | None = None):
        if store is not None and not isinstance(store, TuneStore):
            store = TuneStore(store)
        self.store = store
        self._mem: dict[str, TuneRecord] = {}
        self._lock = threading.RLock()
        self._inflight: dict[str, threading.Lock] = {}   # per-key searches
        self._tel = telemetry.get_registry()
        scope = telemetry.new_scope("tuner")
        self._c_hits = self._tel.counter(
            "netgen_tune_hits_total", tuner=scope)
        self._c_store_hits = self._tel.counter(
            "netgen_tune_store_hits_total", tuner=scope)
        self._c_tunes = self._tel.counter(
            "netgen_tune_searches_total", tuner=scope)
        self._c_measurements = self._tel.counter(
            "netgen_tune_measurements_total", tuner=scope)
        self._c_rejected = self._tel.counter(
            "netgen_tune_rejected_total", tuner=scope)
        self._h_measure = self._tel.histogram(
            "netgen_tune_measure_seconds", tuner=scope)

    @property
    def stats(self) -> TuneStats:
        """Snapshot of the tuner's counters (atomic; safe to read while
        other threads search)."""
        return TuneStats(
            hits=int(self._c_hits.value),
            store_hits=int(self._c_store_hits.value),
            tunes=int(self._c_tunes.value),
            measurements=int(self._c_measurements.value),
            rejected=int(self._c_rejected.value),
            measure_seconds=float(self._h_measure.sum))

    def record_for(self, key: str) -> TuneRecord | None:
        """The resident (memory or store) record under `key`, without
        triggering a search; counts no hit/miss."""
        with self._lock:
            rec = self._mem.get(key)
        if rec is None and self.store is not None:
            rec = self.store.get(key)
        return rec

    def _lookup(self, key: str) -> tuple[TuneRecord | None, str]:
        """(record, tier) under the tuner lock; counts the hit. Tier is
        "memory", "store", or "" on a double miss."""
        rec = self._mem.get(key)
        if rec is not None:
            self._c_hits.inc()
            return rec, "memory"
        if self.store is not None:
            rec = self.store.get(key)
            if rec is not None:
                self._mem[key] = rec
                self._c_store_hits.inc()
                return rec, "store"
        return None, ""

    def get_or_run(self, key_fields,
                   run: Callable[[str], tuple[Mapping, Sequence, Mapping]],
                   ) -> tuple[TuneRecord, str]:
        """Content-addressed caller-driven search: the generalization of
        `get_or_tune` for drivers that own their OWN search loop (the
        design-space explorer). Returns `(record, tier)` where tier is
        "memory", "store", or "run".

        On a double miss the per-key in-flight lock is taken and
        `run(key)` performs the search, returning `(best, measurements,
        extra)` — the winning params dict, the ((params, value), ...)
        table, and a JSON-stable payload stored on the record. The
        driver's measurement count rides the shared
        `netgen_tune_measurements_total` counter (one per table row), so
        `TuneStats.measurements == 0` still certifies a warm start."""
        key = tune_key(key_fields)
        with self._lock:
            rec, tier = self._lookup(key)
            if rec is not None:
                return rec, tier
            key_lock = self._inflight.setdefault(key, threading.Lock())
        with key_lock:
            with self._lock:
                rec, tier = self._lookup(key)
            if rec is not None:
                return rec, tier
            t0 = time.perf_counter()
            best, measurements, extra = run(key)
            dt = time.perf_counter() - t0
            rec = TuneRecord(
                key=key,
                best=dict(best),
                measurements=tuple((dict(p), float(v))
                                   for p, v in measurements),
                device_kind=_field(key_fields, "device_kind"),
                created_unix=time.time(),
                extra=dict(extra),
            )
            self._c_measurements.inc(len(rec.measurements))
            self._c_tunes.inc()
            self._h_measure.observe(dt)
            with self._lock:
                self._mem[key] = rec
                self._inflight.pop(key, None)
            if self.store is not None:
                self.store.put(rec)
            return rec, "run"

    def publish(self, key_fields, best: Mapping, *,
                measurements: Sequence = (), extra: Mapping | None = None,
                ) -> TuneRecord:
        """Unconditionally upsert a record for this problem — no search,
        no measurement counters. The design-space explorer publishes its
        winning datapath under the `cuda-explored` key this way: a
        re-exploration with a different objective may legitimately
        REPLACE the resident winner (unlike `get_or_tune`/`get_or_run`
        records, which are immutable functions of their key)."""
        key = tune_key(key_fields)
        rec = TuneRecord(
            key=key,
            best=dict(best),
            measurements=tuple((dict(p), float(v)) for p, v in measurements),
            device_kind=_field(key_fields, "device_kind"),
            created_unix=time.time(),
            extra=dict(extra or {}),
        )
        with self._lock:
            self._mem[key] = rec
        if self.store is not None:
            self.store.put(rec)
        return rec

    def get_or_tune(self, key_fields, candidates: Sequence[Mapping],
                    measure: Callable[[Mapping], float], *,
                    reps: int = 2,
                    legal: Callable[[Mapping], str | None] | None = None,
                    ) -> dict:
        """The winning parameter dict for this problem — from memory,
        then the store, then by timing every candidate.

        `key_fields` is the JSON-stable problem identity (target, device
        kind, plan signature, the candidate grid itself — so a changed
        grid re-tunes instead of serving a winner the new grid cannot
        express). `measure(params)` runs one candidate once and returns
        its wall-clock seconds; the driver takes best-of-`reps` after
        one untimed warmup call (a first launch's build and layout
        copies must not pollute the measurement).

        `legal(params)`, when given, is a static legality check (see
        `repro_torch.netgen.analysis.tile_legality`): it returns None for a
        candidate worth measuring or a reason string for one that is
        statically illegal / a duplicate kernel launch — rejected
        candidates are skipped without spending a measurement and
        counted in `netgen_tune_rejected_total`. The problem key is
        computed over the FULL declared grid either way, so adding a
        legality filter does not invalidate persisted records. All
        candidates rejected is an error (the grid cannot express a
        launchable kernel).
        """
        if not candidates:
            raise ValueError("no tuning candidates")
        key = tune_key(key_fields)

        with self._lock:
            rec, _ = self._lookup(key)
            if rec is not None:
                return dict(rec.best)
            key_lock = self._inflight.setdefault(key, threading.Lock())

        # Measure OUTSIDE the tuner-wide lock (a paper-sized search
        # takes seconds — unrelated keys must not queue behind it); the
        # per-key lock still ensures concurrent compiles of the SAME
        # shape run one search, with losers re-reading the result.
        with key_lock:
            with self._lock:
                rec, _ = self._lookup(key)
            if rec is not None:
                return dict(rec.best)
            kept, rejected = list(candidates), []
            if legal is not None:
                kept = []
                for cand in candidates:
                    reason = legal(cand)
                    (kept if reason is None else rejected).append(
                        cand if reason is None else (cand, reason))
                if rejected:
                    self._c_rejected.inc(len(rejected))
                if not kept:
                    first = rejected[0][1]
                    raise ValueError(
                        f"all {len(candidates)} tuning candidates are "
                        f"statically illegal (first: {first})")
            t0 = time.perf_counter()
            with self._tel.span("netgen.tune.search", key=key[:12],
                                candidates=len(kept),
                                rejected=len(rejected)) as sp:
                table = []
                for cand in kept:
                    cand = dict(cand)
                    measure(cand)                  # warmup (trace/compile)
                    best = min(measure(cand) for _ in range(max(1, reps)))
                    table.append((cand, best * 1e6))
                winner = dict(min(table, key=lambda t: t[1])[0])
                sp.set_attr("winner", winner)
            dt = time.perf_counter() - t0
            rec = TuneRecord(
                key=key,
                best=winner,
                measurements=tuple(table),
                device_kind=_field(key_fields, "device_kind"),
                created_unix=time.time(),
            )
            self._c_measurements.inc(len(table))
            self._c_tunes.inc()
            self._h_measure.observe(dt)
            with self._lock:
                self._mem[key] = rec
                self._inflight.pop(key, None)
            if self.store is not None:
                self.store.put(rec)
            return dict(rec.best)


def _field(key_fields, name: str) -> str:
    if isinstance(key_fields, Mapping):
        return str(key_fields.get(name, "unknown"))
    return "unknown"


_DEFAULT_TUNER: KernelTuner | None = None
_DEFAULT_LOCK = threading.Lock()


def default_tuner() -> KernelTuner:
    """The process-wide in-memory tuner `tuned=true` compiles fall back
    to when no `Session(tune_store=...)` tuner is threaded through —
    same-process reuse only; configure a store for cross-process."""
    global _DEFAULT_TUNER
    with _DEFAULT_LOCK:
        if _DEFAULT_TUNER is None:
            _DEFAULT_TUNER = KernelTuner()
        return _DEFAULT_TUNER
