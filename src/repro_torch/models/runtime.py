"""Runtime flags threaded into model code.

Counterpart of `repro/models/runtime.py`. The named-flag half: a
thread-local dict of perf-variant switches that a `with_flags(...)`
block sets and `flag(name, default)` reads. A nested block adds to the
enclosing one's flags and restores them on exit. The port's MoE layer
reads `moe_impl` ("shardmap": the all-to-all dispatch of
`layers/moe_shardmap.py` under an active mesh); it ignores the
reference's layout-only `moe_token_shard` and `moe_expert_aligned`.

The scan half: the reference unrolls its XLA layer scans inside
`unrolled_scans()` (`scan_kwargs()` gives `{"unroll": True}`), because
XLA's cost analysis counts a loop body once. The port's layer loops are
Python loops, and its counting mode (`launch/cost.py`) sees every
layer's ops, so there is nothing to unroll: `unrolled_scans()` sets the
flag that `unrolling()` reads, and `scan_kwargs()` returns `{}` either
way.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["unrolled_scans", "unrolling", "scan_kwargs", "with_flags", "flag", "snapshot"]

_ctx = threading.local()


def unrolling() -> bool:
    return getattr(_ctx, "unroll", False)


@contextlib.contextmanager
def unrolled_scans():
    prev = unrolling()
    _ctx.unroll = True
    try:
        yield
    finally:
        _ctx.unroll = prev


def scan_kwargs() -> dict:
    """kwargs for layer loops: none, unrolled or not (the loops are
    Python loops, each layer's ops already run one by one)."""
    return {}


def _flags() -> dict:
    if not hasattr(_ctx, "flags"):
        _ctx.flags = {}
    return _ctx.flags


@contextlib.contextmanager
def with_flags(**kw):
    prev = dict(_flags())
    _flags().update(kw)
    try:
        yield
    finally:
        _ctx.flags = prev


def flag(name: str, default=None):
    return _flags().get(name, default)


def snapshot():
    """A context manager that sets exactly this thread's current flags
    (for code that runs later on another thread: a recomputed layer)."""
    return _restored(dict(_flags()))


@contextlib.contextmanager
def _restored(flags: dict):
    prev = dict(_flags())
    _ctx.flags = dict(flags)
    try:
        yield
    finally:
        _ctx.flags = prev
