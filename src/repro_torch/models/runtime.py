"""Named runtime flags threaded into model code.

Counterpart of the named-flag half of `repro/models/runtime.py`: a
thread-local dict of perf-variant switches that a `with_flags(...)`
block sets and `flag(name, default)` reads. A nested block adds to the
enclosing one's flags and restores them on exit. The port's MoE layer
reads `moe_impl` ("shardmap": the all-to-all dispatch of
`layers/moe_shardmap.py` under an active mesh); it ignores the
reference's layout-only `moe_token_shard` and `moe_expert_aligned`.
The reference's scan half (`unrolled_scans`, `scan_kwargs`) unrolls
XLA layer scans for its cost analysis and waits for the port's
roofline (ROADMAP.md, A.8).
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["with_flags", "flag", "snapshot"]

_ctx = threading.local()


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
