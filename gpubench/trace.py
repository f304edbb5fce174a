"""Reduction of a `torch.profiler` trace of whole batches to the numbers
the per-layer readers take.

The harness wraps each batch's call into the engine in a
`record_function` span of its own (`BATCH_SPAN`); nothing inside the
program is instrumented. From the profiler's raw (Kineto) events:

- device operations: every event on the CUDA device that is not one of
  the harness's spans; kernels are those that are not a memcpy or a
  memset;
- the traced window: from the first batch span's start to the last one's
  end; `busy_s` is the union of the device operations' intervals inside
  it, and the device's idle share is 1 − busy / window;
- a batch's decode steps: its last Σ decode seconds (the engine's own
  `stats["decode_s"]`), since a step ends on the host only after its
  kernels have run, and the prefill's kernels have all run before the
  first step starts; a kernel that starts inside that stretch is a
  decode step's;
- the breakdown: the device operations that took most time, summed by
  name, and the idle gaps of the device, summed by what the host was
  doing (the innermost aten operation running at the gap's middle, or
  "python" where none was), each with the phase it fell in.
"""
from __future__ import annotations

import bisect
import dataclasses

__all__ = ["BATCH_SPAN", "Trace", "reduce"]

BATCH_SPAN = "gpubench.batch"
_TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s_by_name: dict = dataclasses.field(default_factory=dict)
    decode_kernels: int = 0
    decode_steps: int = 0
    batches: list = dataclasses.field(default_factory=list)   # (rows, length) traced
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name `match` accepts."""
        return sum(s for name, s in self.kernel_s_by_name.items() if match(name))


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def _device_type_name(e) -> str:
    return str(e.device_type()).rsplit(".", 1)[-1].upper()


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof, batches: list) -> Trace:
    """`batches`: the traced batches in order, each (rows, length,
    decode seconds list). Returns the `Trace`."""
    events = prof.profiler.kineto_results.events()
    spans, device, host = [], [], []
    for e in events:
        name = e.name()
        kind = _device_type_name(e)
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if name.startswith("gpubench."):
            if kind == "CPU" and name == BATCH_SPAN:
                spans.append((start, end))
            continue
        if kind == "CUDA":
            device.append((start, end, name))
        elif kind == "CPU" and name.startswith("aten::"):
            host.append((start, end, name))
    spans.sort()
    t = Trace()
    if len(spans) != len(batches) or not spans:
        raise RuntimeError(f"trace: {len(spans)} batch spans for {len(batches)} batches")
    w0, w1 = spans[0][0], spans[-1][1]
    t.window_s = (w1 - w0) / 1e9
    decode_ranges = []
    for (s, e), (rows, length, decode_s) in zip(spans, batches):
        decode_ranges.append((e - int(sum(decode_s) * 1e9), e))
        t.decode_steps += len(decode_s)
        t.batches.append((rows, length))
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _merge([[s, e] for s, e, _ in inside])
    t.busy_s = sum(e - s for s, e in busy) / 1e9
    by_name: dict = {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        if not _is_copy(n):
            t.kernel_s_by_name[n] = t.kernel_s_by_name.get(n, 0.0) + (e - s) / 1e9
            if any(a <= s < b for a, b in decode_ranges):
                t.decode_kernels += 1
    t.device_ops = [[n[:120], s] for n, s in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]]
    t.idle_gaps = _idle_gaps(busy, (w0, w1), spans, decode_ranges, host)
    return t


def _idle_gaps(busy: list, window: tuple, spans: list, decode_ranges: list,
               host: list) -> list:
    """Idle seconds of the device summed by (phase, host activity)."""
    host.sort()
    starts = [h[0] for h in host]
    edges = [window[0]] + [x for b in busy for x in b] + [window[1]]
    by_label: dict = {}
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        if any(a <= mid < b for a, b in decode_ranges):
            phase = "decode"
        elif any(a <= mid < b for a, b in spans):
            phase = "prefill"
        else:
            phase = "between_batches"
        what = "python"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(-1, j - 64), -1):
            if host[k][1] >= mid:
                what = host[k][2]
                break
        label = f"{phase}:{what}"
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e9
    return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:_TOP]]
