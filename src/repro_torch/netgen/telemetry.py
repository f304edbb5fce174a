"""`netgen.telemetry` — metrics, tracing and profiling for the compiler.

Counterpart of `repro/netgen/telemetry.py`, with the same metric names,
label keys, span names and export formats, so `benchmarks/check_trace.py`
gates the port's traces unchanged. A zero-dependency (stdlib-only),
thread-safe registry of

  Counter     monotonically increasing value (int or float seconds),
              atomic under its own lock — the backing store for every
              `*Stats` snapshot in the package (CacheStats, StoreStats,
              NetServer.dispatch_counts, EngineStats), so counters
              shared across threads can never lose increments.
  Gauge       last-written value (e.g. flops of a compiled artifact).
  Histogram   latency/occupancy observations with EXACT percentiles
              (nearest-rank p50/p95/p99 over a bounded window of the
              most recent observations; count/sum are all-time).
  Span        nested wall-clock trace spans with structured attributes.
              Parentage is per-thread (a thread-local stack), so spans
              opened on a worker thread root their own trace. Finished
              spans land in a bounded ring buffer.

Metrics are ALWAYS live — they are the package's stats backbone and
cost one lock + one add per update — while *tracing* is opt-in: a span
is live after `enable()` (until `disable()`) and, without it, while a
`torch.profiler` records in the process (checked only once `torch` is
imported, so the module stays stdlib-only). Otherwise `span()` returns
a shared no-op context. A live span stamps its start and end with
`time.time_ns()`, the clock of the profiler's (Kineto's) events, so a
span can be laid over a device trace; it opens no profiler range, so it
adds no event to that trace. A `device_span()`, and every span opened
inside one, also records a timing `torch.cuda.Event` at entry and at
exit on the stream current at entry, where CUDA is initialised and that
stream is not capturing a graph: `SpanRecord.device_s` is the stream's
time between the two, resolved when first read, after the caller's
`synchronize()`; None elsewhere. Only the subtrees whose device time is
read take events: each costs tens of µs of host time, more under the
profiler, which would slow a host-paced loop and show as device idle.

Exporters:

  report()           human table: every counter/gauge, histogram
                     count/mean/p50/p95/p99, span totals by name
  prometheus()       Prometheus text exposition (counters, gauges, and
                     summary-style histograms with quantile labels)
  export_jsonl(path) one JSON object per finished span (trace_id /
                     span_id / parent_id / name / start / duration /
                     attrs), format `netgen-trace-v1`
  summary()          a JSON-stable dict of everything

Profiling hook: `jit_cost(fn, shape)` returns {"flops", "bytes_accessed"}
for a predictor of the `cuda` and `fused` targets at a sample input
shape, counted from the plan the predictor was built from (each input
read once, each output written once; a multiply-add per weight per
row), and None for any other callable; it never raises. With
`enable(profile=True)` the Session driver records it per compiled
artifact (`Artifact.timings["cost_analysis"]`, plus flops/bytes gauges).

Instrumented span tree (what a trace of one request lifecycle nests):

    netgen.compile          target, pipeline, digest
      netgen.lower
      netgen.pipeline       pipeline string
        netgen.pass         per pass: terms/nodes before -> after
      netgen.analysis       pre-backend range analysis + proof summary
      netgen.backend
    netgen.engine.batch     one formed batch (engine, versions, rows) —
                            opened on the batcher thread, so it roots
                            its own trace and parents the dispatch
      netgen.dispatch       path=single|stacked|fallback
        netgen.kernel       one per slot round, closed after the answers
                            reach the host
    netgen.store.load       artifact rebuilt from disk

Served LMs (`repro_torch.serve.engine.Engine.generate`; the Mamba2
mixer's spans; `weights.cast` in every family's `layers.common.wx`):

    serve.generate          one call: rows, length, new — roots its trace
      serve.cache_init      the cache drawn for the call: bytes (device_span)
      serve.prefill         api.prefill through the first token on the host
                            (device_span: it and its subtree take events)
        model.embed
        model.layer         one layer: norm, mixer, residual, state casts
          mixer.in_proj
            weights.cast    a master cast to the compute dtype: bytes
          mixer.conv        the causal conv, bias, SiLU: the conv kernel
                            on x|B|C in place (prefill on the card,
                            route=kernel) or the cat and composed ops
          mixer.ssd         the scan (or the decode state update), D skip
          mixer.gate_norm
          mixer.out_proj
            weights.cast
        zamba.shared_block  Zamba2's published layout: a site's shared
                            block (site, block), its adapter and linear
          attn.core         the attention core: route (flash, dense,
                            decode), rows, q_len, kv_len, heads,
                            kv_heads, head_dim, pairs, causal_pairs
        model.head          final norm and lm_head
        model.cache_stack   the stacks of the new cache
        serve.sync          the tokens' gather and copy to the host
      serve.decode_step     one greedy step: step; children as the prefill's
                            (host stamps only)

Serving metrics: `netgen_predict_latency_seconds{server,version}`
records per-version SERVICE time and `netgen_requests_total` counts one
increment per dispatch call per version — `benchmarks/check_trace.py`
gates latency count == request count.
`netgen_kernel_launches_total{form}` counts kernel launches per
datapath form (`kernel_launches(form)` is the accessor backends use):
the per-layer chains record depth launches per call (times M for the
looped multi chain) while the fusednet megakernel and the `fused`
kernel record exactly ONE per call — `benchmarks/check_trace.py` gates
that every fusednet `netgen.kernel` dispatch-round span carries
launches == 1. The online engine (`repro_torch.netgen.engine`) adds,
per `engine=` scope: `netgen_engine_submitted/completed/batches_total`,
`netgen_engine_rejected_total{reason=queue_full|deadline|closed}`, the
`netgen_engine_queue_depth` gauge, and the
`netgen_engine_queue_wait_seconds` / `netgen_engine_batch_rows`
histograms — queue wait is recorded separately from service time, so
SLO analysis can split time-in-queue from time-on-kernel.

Static-analysis metrics (`repro_torch.netgen.analysis`):
`netgen_verify_failures_total{phase=pipeline|compile}` counts invariant
violations the verifier observed (production compiles count and
continue; strict mode raises instead — see NETGEN_VERIFY);
`netgen_stack_incompat_total{server,reason}` counts version sets the
NetServer diagnosed as unstackable, labelled with the first failing
check (e.g. stack.depth, stack.classes, stack.build).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import sys
import threading
import time
from collections import deque
from typing import Mapping

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "SpanRecord", "counter",
    "device_span", "disable", "enable", "export_jsonl", "gauge", "get_registry",
    "histogram", "jit_cost", "kernel_launches", "new_scope", "prometheus",
    "report", "reset", "span", "summary", "timed",
]

_TRACE_FORMAT = "netgen-trace-v1"


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter; `inc` is atomic (per-counter lock), so the
    `*Stats` mutation paths are race-free without their owners' locks."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Mapping):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written value (settable, also `add` for running levels)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Mapping):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Observations with exact nearest-rank percentiles.

    The sample window is bounded (`window` most recent observations,
    default 65536) so a long-lived server cannot grow without limit;
    percentiles are exact over that window, `count`/`sum` are all-time.
    """

    __slots__ = ("name", "labels", "_lock", "_values", "_count", "_sum")

    def __init__(self, name: str, labels: Mapping, window: int = 65536):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._values: deque = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self._values.append(v)
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile over the retained window;
        `q` in (0, 1] (0.5 -> p50). 0.0 on an empty histogram."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {q}")
        with self._lock:
            xs = sorted(self._values)
        if not xs:
            return 0.0
        return xs[max(math.ceil(q * len(xs)) - 1, 0)]

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p95(self) -> float:
        return self.percentile(0.95)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": self.p50, "p95": self.p95, "p99": self.p99}

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            self._count = 0
            self._sum = 0.0


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span, as exported to the JSONL trace. `start_ns` and
    `end_ns`: `time.time_ns()` at entry and exit (the profiler's clock).
    `device_time`: the device seconds, or the (entry, exit) CUDA events
    they are read from (`device_s`), or None."""
    trace_id: int
    span_id: int
    parent_id: int | None
    name: str
    start_unix: float
    duration_s: float
    attrs: dict
    thread: str
    error: str | None = None
    start_ns: int = 0
    end_ns: int = 0
    device_time: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def device_s(self) -> float | None:
        """Seconds on the stream between the span's entry and exit events
        (waits for the exit event if it has not run yet); None where no
        events were recorded."""
        d = self.device_time
        if d is None or isinstance(d, (int, float)):
            return d
        start, end = d
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        object.__setattr__(self, "device_time", seconds)
        return seconds

    def as_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_unix": self.start_unix,
            "duration_s": self.duration_s,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "attrs": self.attrs,
            "thread": self.thread,
        }
        if self.device_time is not None:
            d["device_s"] = self.device_s
        if self.error is not None:
            d["error"] = self.error
        return d


class _NullSpan:
    """Shared no-op context returned while tracing is disabled: the hot
    path allocates nothing and `set_attr` vanishes."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    def set_attr(self, key, value) -> None:
        pass


_NULL_SPAN = _NullSpan()

_profiler_enabled = None      # torch's check, looked up once torch is imported


def _profiling() -> bool:
    """Whether a torch profiler is recording in the process; False until
    `torch` is imported (this module never imports it)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        autograd = getattr(sys.modules.get("torch"), "autograd", None)
        if autograd is None:
            return False
        _profiler_enabled = autograd._profiler_enabled
    return _profiler_enabled()


def _timing_stream():
    """The current CUDA stream, or None where CUDA is not initialised or
    the stream is capturing a graph."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized() \
            or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream()


def _event(stream):
    """A timing event recorded on `stream` now."""
    ev = sys.modules["torch"].cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    """A live span: context manager that records itself into the
    registry's ring buffer on exit. Parentage comes from the thread's
    span stack, so nesting follows lexical `with` structure per thread.
    `device`: record the span's device time, as every span inside it does."""

    __slots__ = ("_reg", "name", "attrs", "trace_id", "span_id", "parent_id",
                 "start_unix", "start_ns", "_t0", "_device", "_stream", "_ev0")

    def __init__(self, reg: "Registry", name: str, attrs: dict, device: bool = False):
        self._reg = reg
        self.name = name
        self.attrs = attrs
        self._device = device

    def set_attr(self, key, value) -> None:
        self.attrs[key] = value

    def __enter__(self):
        reg = self._reg
        self.span_id = reg._next_id()
        stack = reg._stack()
        if stack:
            parent = stack[-1]
            self.parent_id = parent.span_id
            self.trace_id = parent.trace_id
            self._device = self._device or parent._device
        else:
            self.parent_id = None
            self.trace_id = self.span_id
        stack.append(self)
        self._stream = _timing_stream() if self._device else None
        self._ev0 = None if self._stream is None else _event(self._stream)
        self.start_ns = time.time_ns()
        self.start_unix = self.start_ns / 1e9
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        duration = time.perf_counter() - self._t0
        end_ns = time.time_ns()
        ev1 = None if self._stream is None else _event(self._stream)
        stack = self._reg._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:              # exited out of order: still unwind
            stack.remove(self)
        self._reg._record((             # SpanRecord's fields, in order
            self.trace_id, self.span_id, self.parent_id, self.name,
            self.start_unix, duration, dict(self.attrs),
            threading.current_thread().name, None if et is None else et.__name__,
            self.start_ns, end_ns, None if ev1 is None else (self._ev0, ev1),
        ))
        return False


class _Timed:
    """`timed()` context: observes elapsed seconds into a histogram on
    exit and exposes it as `.elapsed` (what the benches read back)."""

    __slots__ = ("_hist", "_t0", "elapsed")

    def __init__(self, hist: Histogram):
        self._hist = hist
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.elapsed = time.perf_counter() - self._t0
        self._hist.observe(self.elapsed)
        return False


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class Registry:
    """The metric + trace store. One process-wide instance
    (`get_registry()`) backs the whole package; tests may build their
    own. `enabled` gates tracing only — metrics are always live (see
    module doc). `profile` additionally asks the compile driver to run
    `jit_cost` on every compiled callable artifact."""

    def __init__(self, *, max_spans: int = 65536, hist_window: int = 65536):
        self._lock = threading.Lock()
        self._metrics: "dict[tuple, Counter | Gauge | Histogram]" = {}
        self._spans: deque = deque(maxlen=max_spans)
        self._hist_window = hist_window
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._id_lock = threading.Lock()
        self.enabled = False
        self.profile = False

    # -- internals -----------------------------------------------------------

    def _next_id(self) -> int:
        with self._id_lock:
            return next(self._ids)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, fields: tuple) -> None:
        """Keep a finished span as the tuple of its `SpanRecord` fields:
        the record is built when read, off the traced code's path."""
        with self._lock:
            self._spans.append(fields)

    @staticmethod
    def _key(kind: str, name: str, labels: Mapping) -> tuple:
        return (kind, name,
                tuple(sorted((k, str(v)) for k, v in labels.items())))

    def _metric(self, kind: str, name: str, labels: Mapping):
        key = self._key(kind, name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                labdict = dict(key[2])
                if kind == "counter":
                    m = Counter(name, labdict)
                elif kind == "gauge":
                    m = Gauge(name, labdict)
                else:
                    m = Histogram(name, labdict, window=self._hist_window)
                self._metrics[key] = m
            return m

    # -- metric accessors (get-or-create) ------------------------------------

    def counter(self, name: str, /, **labels) -> Counter:
        return self._metric("counter", name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._metric("gauge", name, labels)

    def histogram(self, name: str, /, **labels) -> Histogram:
        return self._metric("histogram", name, labels)

    # -- tracing -------------------------------------------------------------

    def span(self, name: str, /, **attrs):
        """A nested trace span (no-op unless `enabled` or a torch profiler
        is recording); attributes are keyword arguments plus anything set
        via `set_attr` inside."""
        if not self.enabled and not _profiling():
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def device_span(self, name: str, /, **attrs):
        """`span()` that also records its device seconds and those of
        every span opened inside it (`SpanRecord.device_s`)."""
        if not self.enabled and not _profiling():
            return _NULL_SPAN
        return _Span(self, name, attrs, device=True)

    def timed(self, name: str, /, **labels) -> _Timed:
        """Time a block into `histogram(name, **labels)` — the one code
        path for bench timing loops AND production latency metrics."""
        return _Timed(self.histogram(name, **labels))

    def spans(self) -> list[SpanRecord]:
        with self._lock:
            fields = list(self._spans)
        return [SpanRecord(*f) for f in fields]

    # -- exporters -----------------------------------------------------------

    def _sorted_metrics(self) -> list:
        with self._lock:
            items = list(self._metrics.items())
        return sorted(items, key=lambda kv: (kv[0][1], kv[0][2]))

    def report(self) -> str:
        """Human-readable table of every metric plus span totals."""
        lines = []
        for (kind, name, _), m in self._sorted_metrics():
            label = _render_labels(m.labels)
            if kind == "histogram":
                s = m.snapshot()
                unit = 1e3 if name.endswith("_seconds") else 1.0
                suffix = " ms" if unit == 1e3 else ""
                lines.append(
                    f"histogram {name}{label}: count={s['count']} "
                    f"mean={s['mean'] * unit:.3g}{suffix} "
                    f"p50={s['p50'] * unit:.3g}{suffix} "
                    f"p95={s['p95'] * unit:.3g}{suffix} "
                    f"p99={s['p99'] * unit:.3g}{suffix}")
            else:
                v = m.value
                shown = f"{v:.6g}" if isinstance(v, float) else str(v)
                lines.append(f"{kind:9s} {name}{label}: {shown}")
        by_name: dict[str, list[float]] = {}
        for rec in self.spans():
            by_name.setdefault(rec.name, []).append(rec.duration_s)
        for name in sorted(by_name):
            durs = by_name[name]
            lines.append(
                f"span      {name}: n={len(durs)} "
                f"total={sum(durs) * 1e3:.3g} ms "
                f"max={max(durs) * 1e3:.3g} ms")
        return "\n".join(lines)

    def prometheus(self) -> str:
        """Prometheus text exposition: counters, gauges, and histograms
        as summaries (`quantile` labels + `_sum`/`_count`)."""
        out = []
        last_typed = None
        for (kind, name, _), m in self._sorted_metrics():
            if (kind, name) != last_typed:
                ptype = {"counter": "counter", "gauge": "gauge",
                         "histogram": "summary"}[kind]
                out.append(f"# TYPE {name} {ptype}")
                last_typed = (kind, name)
            if kind == "histogram":
                for q in (0.5, 0.95, 0.99):
                    lab = _render_labels({**m.labels, "quantile": q})
                    out.append(f"{name}{lab} {m.percentile(q):.9g}")
                lab = _render_labels(m.labels)
                out.append(f"{name}_sum{lab} {m.sum:.9g}")
                out.append(f"{name}_count{lab} {m.count}")
            else:
                lab = _render_labels(m.labels)
                v = m.value
                shown = f"{v:.9g}" if isinstance(v, float) else str(v)
                out.append(f"{name}{lab} {shown}")
        return "\n".join(out) + ("\n" if out else "")

    def export_jsonl(self, path) -> int:
        """Write every retained finished span as one JSON object per
        line; returns the number of spans written."""
        spans = self.spans()
        with open(path, "w") as f:
            for rec in spans:
                f.write(json.dumps(rec.as_dict(), sort_keys=True))
                f.write("\n")
        return len(spans)

    def summary(self) -> dict:
        """JSON-stable dict of everything."""
        counters, gauges, hists = [], [], []
        for (kind, name, _), m in self._sorted_metrics():
            entry = {"name": name, "labels": m.labels}
            if kind == "counter":
                counters.append({**entry, "value": m.value})
            elif kind == "gauge":
                gauges.append({**entry, "value": m.value})
            else:
                hists.append({**entry, **m.snapshot()})
        return {"format": _TRACE_FORMAT, "counters": counters,
                "gauges": gauges, "histograms": hists,
                "spans_retained": len(self.spans())}

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        """Zero every metric in place (live component handles stay
        valid) and drop all retained spans. `enabled`/`profile` keep
        their values."""
        with self._lock:
            metrics = list(self._metrics.values())
            self._spans.clear()
        for m in metrics:
            m.reset()


def _render_labels(labels: Mapping) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(
            (k, str(v)) for k, v in labels.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


# ---------------------------------------------------------------------------
# Profiling hook
# ---------------------------------------------------------------------------

_ITEMSIZE = {"uint8": 1, "int8": 1, "int32": 4}


def jit_cost(fn, shape, dtype="uint8") -> dict | None:
    """Operations and bytes of one call of a port predictor at a sample
    input shape: {"flops", "bytes_accessed"} — the roofline inputs for
    one compiled artifact. `shape` is (B, n_in), or (M, B, n_in) for a
    stacked dispatch. Counted from what the backend stamped on the
    predictor when it built it (`weight_bytes`, `ops_per_row`): the
    input read once, every weight array read once, one int32 answer a
    row written once, and the layers' integer operations (a multiply
    and an add per weight per row). Returns None for any callable that
    carries no such count and for a malformed shape; a telemetry hook
    must never fail a compile."""
    weight_bytes = getattr(fn, "weight_bytes", None)
    ops_per_row = getattr(fn, "ops_per_row", None)
    if weight_bytes is None or ops_per_row is None:
        return None
    try:
        dims = [int(d) for d in shape]
        itemsize = _ITEMSIZE[str(dtype)]
    except (TypeError, ValueError, KeyError):
        return None
    if len(dims) < 2 or min(dims) < 0:
        return None
    rows = math.prod(dims[:-1])
    return {"flops": float(rows * ops_per_row),
            "bytes_accessed": float(rows * dims[-1] * itemsize
                                    + weight_bytes + rows * 4)}


# ---------------------------------------------------------------------------
# Process-wide default registry + module-level convenience API
# ---------------------------------------------------------------------------

_REGISTRY = Registry()

_SCOPE_LOCK = threading.Lock()
_SCOPE_IDS: dict[str, int] = {}


def new_scope(prefix: str) -> str:
    """A process-unique instance label (`cache-0`, `server-3`, ...) so
    per-instance stats (two CompileCaches, say) never merge in the
    shared registry."""
    with _SCOPE_LOCK:
        n = _SCOPE_IDS.get(prefix, 0)
        _SCOPE_IDS[prefix] = n + 1
    return f"{prefix}-{n}"


def get_registry() -> Registry:
    return _REGISTRY


def enable(profile: bool = False) -> None:
    """Turn span tracing on (metrics are always live). `profile=True`
    additionally records `jit_cost` per compiled callable artifact."""
    _REGISTRY.enabled = True
    _REGISTRY.profile = bool(profile)


def disable() -> None:
    _REGISTRY.enabled = False
    _REGISTRY.profile = False


def counter(name: str, /, **labels) -> Counter:
    return _REGISTRY.counter(name, **labels)


def kernel_launches(form: str) -> Counter:
    """The per-datapath launch counter,
    `netgen_kernel_launches_total{form}` — backends increment it by the
    number of kernel launches one predictor call performs (depth per
    chain call, depth x M for the looped multi chain, exactly 1 for the
    fusednet megakernel and the fused kernel)."""
    return _REGISTRY.counter("netgen_kernel_launches_total", form=form)


def gauge(name: str, /, **labels) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, /, **labels) -> Histogram:
    return _REGISTRY.histogram(name, **labels)


def span(name: str, /, **attrs):
    if not _REGISTRY.enabled and not _profiling():    # Registry.span, one call less
        return _NULL_SPAN
    return _Span(_REGISTRY, name, attrs)


def device_span(name: str, /, **attrs):
    return _REGISTRY.device_span(name, **attrs)


def timed(name: str, /, **labels) -> _Timed:
    return _REGISTRY.timed(name, **labels)


def report() -> str:
    return _REGISTRY.report()


def prometheus() -> str:
    return _REGISTRY.prometheus()


def export_jsonl(path) -> int:
    return _REGISTRY.export_jsonl(path)


def summary() -> dict:
    return _REGISTRY.summary()


def reset() -> None:
    _REGISTRY.reset()
