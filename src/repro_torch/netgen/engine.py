"""`netgen.engine` — async online serving: admission queue + continuous
slot batching over the stacked multi-net dispatch.

Counterpart of `repro/netgen/engine.py`. The paper's argument is
inference *throughput*: the FPGA serves a stream of single 28x28
classifications with no per-request software overhead. `NetServer`
alone takes batches the caller has already formed; this module is the
front door for callers that send SINGLE requests, amortizing dispatch
across them by forming slot blocks continuously.

    ServingEngine — owns (or builds) a `NetServer` and a single batcher
        thread. `submit(version, x)` enqueues one uint8 request and
        returns a `concurrent.futures.Future`; `infer` is the blocking
        convenience. The batcher performs *continuous slot formation*:
        it collects requests until some version fills a slot block
        (`slot_capacity` rows) or `max_batch_delay` elapses since the
        first undispatched request — whichever comes first — then
        serves the whole group through `NetServer.predict_many`, so
        stack-compatible versions ride ONE multi-net dispatch per round
        (one `binary_forward_planes` launch for `cuda[planes=true]`).
        The batcher thread launches on its current CUDA stream, the
        default stream, like every other caller of the kernels.

    SLO knobs — `max_batch_delay` trades p50 latency against batch
        fill; `max_queue_depth` bounds admission (a full queue REJECTS
        with `QueueFullError` instead of growing without bound); a
        per-request `deadline` rejects requests that expired while
        queued (`DeadlineExceededError` on the future) before any kernel
        work is spent on them.

    Lifecycle — engines are context managers mirroring `Session`:
        exiting drains the queue (every accepted future resolves) and
        joins the batcher thread; `shutdown(drain=False)` fails pending
        futures with `EngineClosedError` instead. A dropped engine is
        reclaimed by a weakref finalizer, so no thread outlives it.

Telemetry (all labelled `engine=<scope>`, beside the server's own
`netgen_predict_latency_seconds` / `netgen_requests_total` /
`netgen_slot_occupancy`):

    netgen_engine_submitted_total / netgen_engine_completed_total
    netgen_engine_rejected_total{reason=queue_full|deadline|closed}
    netgen_engine_queue_depth          (gauge, post-admission)
    netgen_engine_queue_wait_seconds   (histogram, dequeue - enqueue)
    netgen_engine_batch_rows           (histogram, rows per dispatch)
    netgen.engine.batch                (span around each dispatch)

    session = netgen.Session(store="~/.cache/netgen")      # cuda:0
    with session.engine(target="cuda[planes=true]", slot_capacity=256,
                        max_batch_delay=0.002) as engine:
        engine.register("v1", qnet)
        fut = engine.submit("v1", image)        # (n_inputs,) uint8
        label = fut.result()
        label = engine.infer("v1", image)       # blocking convenience
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future

import numpy as np

from repro_torch.netgen import telemetry
from repro_torch.netgen.serve import NetServer
from repro_torch.netgen.session import _validate_batch
from repro_torch.serve.slots import stack_requests

__all__ = [
    "DeadlineExceededError", "EngineClosedError", "EngineStats",
    "QueueFullError", "ServingEngine",
]


class QueueFullError(RuntimeError):
    """Admission rejected: the queue is at `max_queue_depth`."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline elapsed while it waited in the queue."""


class EngineClosedError(RuntimeError):
    """Submitted to (or pending in) an engine that has shut down."""


@dataclasses.dataclass
class EngineStats:
    """Point-in-time snapshot of one engine's telemetry counters."""
    submitted: int = 0
    completed: int = 0
    rejected_queue_full: int = 0
    rejected_deadline: int = 0
    rejected_closed: int = 0
    batches: int = 0
    queue_depth: int = 0

    def row(self) -> str:
        return (f"engine: {self.submitted} submitted, {self.completed} "
                f"completed in {self.batches} batches, rejected "
                f"{self.rejected_queue_full} full / "
                f"{self.rejected_deadline} deadline / "
                f"{self.rejected_closed} closed, depth {self.queue_depth}")


class _Request:
    """One admitted request: payload, response future, and the queue
    timestamps the SLO knobs act on (absolute perf_counter times)."""

    __slots__ = ("version", "x", "future", "t_enqueue", "deadline")

    def __init__(self, version: str, x: np.ndarray,
                 deadline: float | None):
        self.version = version
        self.x = x
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = (None if deadline is None
                         else self.t_enqueue + float(deadline))


class _EngineCore:
    """Everything the batcher thread touches. Deliberately holds no
    reference to the `ServingEngine` wrapper: the thread keeps the core
    alive, the wrapper's weakref finalizer closes the core, so a
    dropped engine's thread exits instead of pinning it forever."""

    def __init__(self, server: NetServer, max_batch_delay: float,
                 max_queue_depth: int):
        self.server = server
        self.max_batch_delay = float(max_batch_delay)
        self.max_queue_depth = int(max_queue_depth)
        self.cv = threading.Condition()
        self.queue: "deque[_Request]" = deque()
        self.closed = False
        self.tel = telemetry.get_registry()
        self.scope = telemetry.new_scope("engine")
        self.c_submitted = self.tel.counter(
            "netgen_engine_submitted_total", engine=self.scope)
        self.c_completed = self.tel.counter(
            "netgen_engine_completed_total", engine=self.scope)
        self.c_batches = self.tel.counter(
            "netgen_engine_batches_total", engine=self.scope)
        self.c_rejected = {
            reason: self.tel.counter(
                "netgen_engine_rejected_total",
                engine=self.scope, reason=reason)
            for reason in ("queue_full", "deadline", "closed")}
        self.g_depth = self.tel.gauge(
            "netgen_engine_queue_depth", engine=self.scope)
        self.h_queue_wait = self.tel.histogram(
            "netgen_engine_queue_wait_seconds", engine=self.scope)
        self.h_batch_rows = self.tel.histogram(
            "netgen_engine_batch_rows", engine=self.scope)

    # -- batcher thread ------------------------------------------------------

    def loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._serve(batch)

    def _next_batch(self) -> "list[_Request] | None":
        """Continuous slot formation: block for the first request, then
        keep admitting until some version fills a slot block or
        `max_batch_delay` has elapsed — whichever first. Returns up to
        `slot_capacity` requests per version (FIFO; overflow stays
        queued for the next round) or None at drained shutdown."""
        cap = self.server.slot_capacity
        with self.cv:
            while not self.queue:
                if self.closed:
                    return None
                self.cv.wait(0.1)
            deadline_t = time.perf_counter() + self.max_batch_delay
            while not self.closed:
                counts: dict[str, int] = {}
                full = False
                for r in self.queue:
                    c = counts.get(r.version, 0) + 1
                    counts[r.version] = c
                    if c >= cap:
                        full = True
                        break
                remaining = deadline_t - time.perf_counter()
                if full or remaining <= 0:
                    break
                self.cv.wait(remaining)
            taken: list[_Request] = []
            kept: "deque[_Request]" = deque()
            counts = {}
            for r in self.queue:
                c = counts.get(r.version, 0)
                if c < cap:
                    counts[r.version] = c + 1
                    taken.append(r)
                else:
                    kept.append(r)
            self.queue = kept
            self.g_depth.set(len(kept))
            return taken

    def _serve(self, batch: "list[_Request]") -> None:
        """Dispatch one formed batch through the server's shared core.
        Expired deadlines are rejected here — after queueing, before
        kernel work — and a dispatch failure fails only this batch's
        futures, never the batcher thread."""
        now = time.perf_counter()
        live: list[_Request] = []
        for req in batch:
            self.h_queue_wait.observe(now - req.t_enqueue)
            if req.deadline is not None and now > req.deadline:
                self.c_rejected["deadline"].inc()
                if not req.future.cancelled():
                    req.future.set_exception(DeadlineExceededError(
                        f"deadline exceeded after "
                        f"{now - req.t_enqueue:.4f}s in queue"))
                continue
            if not req.future.set_running_or_notify_cancel():
                continue                     # caller cancelled while queued
            live.append(req)
        if not live:
            return
        by_version: "dict[str, list[_Request]]" = {}
        for req in live:
            by_version.setdefault(req.version, []).append(req)
        xs = {v: stack_requests([r.x for r in rs])
              for v, rs in by_version.items()}
        self.c_batches.inc()
        self.h_batch_rows.observe(len(live))
        try:
            with self.tel.span("netgen.engine.batch", engine=self.scope,
                               versions=len(xs), rows=len(live)):
                preds = self.server.predict_many(xs)
        except BaseException as e:  # noqa: BLE001 — fail batch, keep serving
            for req in live:
                req.future.set_exception(e)
            return
        for v, rs in by_version.items():
            for req, p in zip(rs, preds[v]):
                req.future.set_result(int(p))
        self.c_completed.inc(len(live))

    # -- shutdown ------------------------------------------------------------

    def close(self, drain: bool) -> "list[_Request]":
        """Mark closed; with drain the batcher finishes the queue, else
        the pending requests are returned for the caller to fail."""
        with self.cv:
            self.closed = True
            dropped: list[_Request] = []
            if not drain:
                dropped = list(self.queue)
                self.queue.clear()
                self.g_depth.set(0)
            self.cv.notify_all()
        return dropped


def _finalize_engine(core: _EngineCore, thread: threading.Thread) -> None:
    """weakref.finalize callback — module-level so it holds no reference
    back to the ServingEngine (which would keep it alive forever)."""
    core.close(drain=True)
    if thread.is_alive():
        thread.join(timeout=10.0)


class ServingEngine:
    """The async online front door over a `NetServer` (see module doc).

    Construction: pass an existing `server=`, or `session=` (plus
    `target=`/`pipeline=`) to build one over a `Session`'s compile
    tiers and device — `Session.engine(...)` is the one-liner; with
    neither, the server compiles on the default device (the card; raises
    without CUDA). Register versions through `register` (delegates to
    the server; warmup runs before publication, so the engine never
    serves a cold predictor).
    """

    def __init__(self, server: NetServer | None = None, *, session=None,
                 target: str | None = None, pipeline=None,
                 slot_capacity: int = 256, warmup: bool = True,
                 max_batch_delay: float = 0.002,
                 max_queue_depth: int = 4096):
        if max_batch_delay < 0:
            raise ValueError(
                f"max_batch_delay must be >= 0, got {max_batch_delay}")
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if server is not None:
            if session is not None or target is not None \
                    or pipeline is not None:
                raise ValueError(
                    "pass server= OR session=/target=/pipeline=, not both")
        else:
            server = NetServer(
                session=session,
                target=target if target is not None else "torch",
                pipeline=pipeline, slot_capacity=slot_capacity,
                warmup=warmup)
        self._core = _EngineCore(server, max_batch_delay, max_queue_depth)
        self._thread: threading.Thread | None = None
        self._finalizer = None

    # -- delegation to the server -------------------------------------------

    @property
    def server(self) -> NetServer:
        return self._core.server

    @property
    def scope(self) -> str:
        return self._core.scope

    @property
    def max_batch_delay(self) -> float:
        return self._core.max_batch_delay

    @property
    def max_queue_depth(self) -> int:
        return self._core.max_queue_depth

    def register(self, version: str, net):
        return self._core.server.register(version, net)

    def unregister(self, version: str) -> None:
        self._core.server.unregister(version)

    def versions(self) -> list[str]:
        return self._core.server.versions()

    # -- admission -----------------------------------------------------------

    def submit(self, version: str, x_uint8, *,
               deadline: float | None = None) -> Future:
        """Enqueue ONE request — a (n_inputs,) uint8 vector — for
        `version`; returns a Future resolving to the predicted class
        (int). `deadline` (seconds from now) rejects the request with
        `DeadlineExceededError` if it is still queued when it expires.
        Raises `QueueFullError` when admission is at `max_queue_depth`
        and `EngineClosedError` after shutdown."""
        x = np.asarray(x_uint8)
        compiled = self._core.server.compiled_for(version)  # KeyError early
        if x.ndim != 1:
            raise ValueError(
                f"submit takes one request of shape "
                f"({compiled.circuit.n_inputs},); got {x.shape} — use "
                f"NetServer.predict for pre-formed batches")
        _validate_batch(x[None, :], compiled.circuit.n_inputs)
        req = _Request(version, x, deadline)
        core = self._core
        with core.cv:
            if core.closed:
                core.c_rejected["closed"].inc()
                raise EngineClosedError("engine is shut down")
            if len(core.queue) >= core.max_queue_depth:
                core.c_rejected["queue_full"].inc()
                raise QueueFullError(
                    f"admission queue at max_queue_depth="
                    f"{core.max_queue_depth}")
            core.queue.append(req)
            core.g_depth.set(len(core.queue))
            self._ensure_thread()
            core.cv.notify()
        core.c_submitted.inc()
        return req.future

    def infer(self, version: str, x_uint8, *, deadline: float | None = None,
              timeout: float | None = None) -> int:
        """Blocking convenience: `submit(...).result(timeout)`."""
        return self.submit(version, x_uint8, deadline=deadline).result(
            timeout)

    def queue_depth(self) -> int:
        with self._core.cv:
            return len(self._core.queue)

    def stats(self) -> EngineStats:
        core = self._core
        return EngineStats(
            submitted=int(core.c_submitted.value),
            completed=int(core.c_completed.value),
            rejected_queue_full=int(core.c_rejected["queue_full"].value),
            rejected_deadline=int(core.c_rejected["deadline"].value),
            rejected_closed=int(core.c_rejected["closed"].value),
            batches=int(core.c_batches.value),
            queue_depth=self.queue_depth())

    # -- lifecycle -----------------------------------------------------------

    def _ensure_thread(self) -> None:
        # called under core.cv: first admission starts the batcher
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._core.loop,
                name=f"netgen-engine-{self._core.scope}", daemon=True)
            self._finalizer = weakref.finalize(
                self, _finalize_engine, self._core, self._thread)
            self._thread.start()

    def shutdown(self, *, drain: bool = True,
                 timeout: float | None = None) -> None:
        """Stop the engine (idempotent). With `drain` (default) every
        already-accepted request is served before the batcher exits;
        otherwise pending futures fail with `EngineClosedError`.
        Further `submit` calls are rejected either way."""
        dropped = self._core.close(drain=drain)
        for req in dropped:
            self._core.c_rejected["closed"].inc()
            if not req.future.cancelled():
                req.future.set_exception(
                    EngineClosedError("engine shut down before dispatch"))
        if self._thread is not None:
            self._thread.join(timeout)
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.shutdown()
