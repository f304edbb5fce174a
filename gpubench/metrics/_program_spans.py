"""The program's own spans, as the `program_span` readers of the served
LM take them: the trees under each `serve.generate` root that the
process's telemetry registry (`repro_torch.netgen.telemetry`) retains.

Spans are live only while the traced cycle's profiler records, so the
trees are the traced cycle's calls. A program that records no such span
gives no tree, and every reader then returns None.
"""
from __future__ import annotations

__all__ = ["calls", "kids", "under", "net_of_casts"]


def calls() -> list:
    """[(root, children)]: each `serve.generate` span that roots its
    trace, and a map from a span id to its child records (one map for
    all roots)."""
    from repro_torch.netgen import telemetry
    spans = telemetry.get_registry().spans()
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)
    return [(s, children) for s in spans
            if s.name == "serve.generate" and s.parent_id is None]


def kids(children: dict, span, name: str) -> list:
    """The children of `span` named `name`."""
    return [c for c in children.get(span.span_id, ()) if c.name == name]


def under(children: dict, span, name: str) -> list:
    """Every descendant of `span` named `name`."""
    out, todo = [], list(children.get(span.span_id, ()))
    while todo:
        s = todo.pop()
        if s.name == name:
            out.append(s)
        todo.extend(children.get(s.span_id, ()))
    return out


def net_of_casts(children: dict, span) -> float:
    """The span's device seconds less those of its `weights.cast` children."""
    return span.device_s - sum(c.device_s for c in kids(children, span, "weights.cast"))
