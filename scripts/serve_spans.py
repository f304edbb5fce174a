"""The program's spans over one benchmark cell's traced cycle, summed by
span, and what a span costs on the host.

    python scripts/serve_spans.py --workload CELL --seed N [--seconds S] [--json OUT]

Runs the cell as `gpubench/run.py --trace 1` does (`core.execute`: set-up,
a window of `--seconds`, one traced cycle, the check), then reads the
spans that the traced cycle recorded, as the `program_span` readers take
them (`gpubench/metrics/_program_spans.py`):

  prefill   device seconds of every `serve.prefill`, by span name, each
            span's own: its seconds less its children's (a `mixer.*`
            span is so net of its `weights.cast`);
  decode    host seconds of every `serve.decode_step`, split the same way;
  conv      each prefill shape's `mixer.conv` spans: device ms a call (the
            mean over the shape's layers), calls, and their `route`s;
  overhead  the traced steps' mean host ms against the window's
            `decode_step_ms` (tracing off), and the share of a traced
            step that the tracing (profiler and spans) takes;
  cost      µs of a `with span(...)` block off, live (host stamps) and
            live as a `device_span` (two CUDA events where CUDA is
            initialised), without and under a profiler of the CPU and
            CUDA activities.

Prints one JSON object (also written to `--json`). Needs one card for
device seconds; on the CPU the prefill table is empty.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _own(children, span, clock, into: dict) -> None:
    """Add each span of `span`'s subtree to `into` by name: its `clock`
    seconds less its children's."""
    kids = children.get(span.span_id, ())
    into[span.name] = into.get(span.name, 0.0) + clock(span) - sum(clock(k) for k in kids)
    for k in kids:
        _own(children, k, clock, into)


def breakdown(decode_step_ms: float | None) -> dict:
    from gpubench.metrics import _program_spans as ps
    pre, dec, steps, conv = {}, {}, [], {}
    for root, children in ps.calls():
        for s in ps.kids(children, root, "serve.prefill"):
            if s.device_s is not None:
                _own(children, s, lambda x: x.device_s, pre)
            shape = conv.setdefault(f"{root.attrs['rows']}x{root.attrs['length']}",
                                    {"device_s": [], "routes": {}})
            for c in ps.under(children, s, "mixer.conv"):
                if c.device_s is not None:
                    shape["device_s"].append(c.device_s)
                route = str(c.attrs.get("route"))
                shape["routes"][route] = shape["routes"].get(route, 0) + 1
        for s in ps.kids(children, root, "serve.decode_step"):
            _own(children, s, lambda x: x.duration_s, dec)
            steps.append(s.duration_s)
    traced = 1e3 * sum(steps) / len(steps) if steps else None
    share = (100.0 * (1.0 - decode_step_ms / traced)
             if traced and decode_step_ms is not None else None)
    conv = {k: {"ms": 1e3 * sum(v["device_s"]) / len(v["device_s"]) if v["device_s"] else None,
                "calls": len(v["device_s"]), "routes": v["routes"]} for k, v in conv.items()}
    return {"prefill_device_s": pre, "decode_host_s": dec, "conv": conv,
            "overhead": {"traced_step_ms": traced, "window_step_ms": decode_step_ms,
                         "tracing_share_of_traced_step": share}}


def span_cost() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netgen import telemetry

    def us(opener, number):
        def block():
            with opener("mixer.conv"):
                pass
        return 1e6 * min(timeit.repeat(block, number=number, repeat=5)) / number

    def costs():
        telemetry.enable()
        out = {"live_us": us(telemetry.span, 5_000),
               "live_device_us": us(telemetry.device_span, 5_000)}
        telemetry.disable()
        telemetry.reset()
        return out

    telemetry.disable()
    out = {"off_us": us(telemetry.span, 100_000), **costs()}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts):
        out["profiled"] = costs()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch

    from gpubench import core
    manifest = core.load_manifest()
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    ctx = core.context(manifest, args.workload, args.seed, args.seconds, True, dev, time.time())
    run, metrics = core.execute(manifest, ctx)
    step = metrics.get("decode_step_ms", {}).get("value")
    out = {"workload": args.workload, "seed": args.seed, "correct": run.correct,
           "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "metrics": metrics, **breakdown(step), "cost": span_cost()}
    text = json.dumps(out, indent=1)
    print(text)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
