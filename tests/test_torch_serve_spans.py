"""The served LM's spans (`netgen.telemetry`), on the CPU at
`configs.smoke("mamba2-2.7b")` (2 layers, d_model 64), and on the card.

A span is live after `telemetry.enable()` or while a torch profiler
records, and the shared no-op otherwise; a live span is stamped on the
profiler's clock; `Engine.generate` records one tree a call (the serving
spans, the model's, the mixer's and the weight casts), and serves the
same tokens, bit for bit, with its spans live or off. Device seconds
exist only where CUDA is initialised, and only the cache's and the
prefill's subtrees record them. Run the card's case (the clock against
Kineto's events of a kernel) with

    python -m pytest -q -m cuda tests/test_torch_serve_spans.py
"""
import dataclasses
import os
import sys
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.models import api, base
from repro_torch.netgen import telemetry
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]
from check_trace import check_spans  # noqa: E402

from gpubench.metrics import _program_spans as ps  # noqa: E402

MIXER = ("mixer.in_proj", "mixer.conv", "mixer.ssd", "mixer.gate_norm", "mixer.out_proj")


@pytest.fixture(autouse=True)
def _clean_registry():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _engine(new: int, device="cpu", dtype="bfloat16"):
    cfg = dataclasses.replace(configs.smoke("mamba2-2.7b"), compute_dtype=dtype)
    params = base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, ServeConfig(max_len=48, max_new_tokens=new), device=device)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (3, 20)).astype(np.int32)
    return cfg, eng, prompts


def _names(children, span):
    return Counter(c.name for c in children.get(span.span_id, ()))


def test_span_is_null_unless_enabled_or_profiled():
    assert telemetry.span("x") is telemetry._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("live", k=1) as sp:
            assert sp is not telemetry._NULL_SPAN
    assert telemetry.span("x") is telemetry._NULL_SPAN
    (rec,) = telemetry.get_registry().spans()
    assert rec.name == "live" and rec.attrs == {"k": 1}
    telemetry.enable()
    assert telemetry.span("x") is not telemetry._NULL_SPAN


def _bracket(device: str, pad_s: float):
    """A live span around one matmul (padded by `pad_s` of sleep on each
    side) under the profiler: (the span, the profiler's events of it)."""
    x = torch.randn(64, 64, device=device)
    torch.mm(x, x)                                        # the library's set-up, outside
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        with telemetry.device_span("around"):
            time.sleep(pad_s)
            torch.mm(x, x)
            if device == "cuda":
                torch.cuda.synchronize()
            time.sleep(pad_s)
    (rec,) = telemetry.get_registry().spans()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm" or str(e.device_type()).endswith("CUDA")]
    return rec, events


def test_live_span_brackets_the_profiler_events_it_ran():
    rec, events = _bracket("cpu", 0.002)
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    assert rec.start_ns < mm.start_ns() and mm.start_ns() + mm.duration_ns() < rec.end_ns
    assert rec.end_ns - rec.start_ns < 1e9 and abs(rec.start_unix - rec.start_ns / 1e9) < 1e-6


def _trace(eng, prompts):
    telemetry.enable()
    out = eng.generate(prompts)
    telemetry.disable()
    return out, telemetry.get_registry().spans()


def test_generate_records_one_tree_a_call():
    n = 4
    cfg, eng, prompts = _engine(n)
    _, spans = _trace(eng, prompts)
    by_id = {s.span_id: s for s in spans}
    ((root, children),) = ps.calls()
    assert [s for s in spans if s.parent_id is None] == [root]
    assert root.attrs == {"rows": 3, "length": 20, "new": n}
    assert {s.trace_id for s in spans} == {root.trace_id}
    assert _names(children, root) == Counter(
        {"serve.cache_init": 1, "serve.prefill": 1, "serve.decode_step": n - 1})
    (init,) = [s for s in children[root.span_id] if s.name == "serve.cache_init"]
    assert init.attrs["bytes"] == sum(t.nbytes for _, t in base.tree_items(_cache_like(cfg, 3)))
    steps = [s for s in children[root.span_id] if s.name == "serve.decode_step"]
    assert [s.attrs["step"] for s in steps] == list(range(n - 1))
    calls = [s for s in children[root.span_id] if s.name != "serve.cache_init"]
    for call in calls:
        assert _names(children, call) == Counter(
            {"serve.sync": 1, "model.embed": 1, "model.layer": cfg.n_layers,
             "model.head": 1, "model.cache_stack": 1})
        for lay in (c for c in children[call.span_id] if c.name == "model.layer"):
            assert _names(children, lay) == Counter(MIXER)
            casts = [g for c in children[lay.span_id] for g in children.get(c.span_id, ())]
            assert [g.name for g in casts] == ["weights.cast"] * 2
            assert sorted(by_id[g.parent_id].name for g in casts) == [
                "mixer.in_proj", "mixer.out_proj"]
    w = eng.params["layers"]["mixer"]["in_proj"]
    in_casts = [g for s in spans if s.name == "mixer.in_proj" for g in children[s.span_id]]
    assert {g.attrs["bytes"] for g in in_casts} == {w[0].numel() * 2}
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert check_spans([s.as_dict() for s in spans], require=("serve.generate",)) == []


def _cache_like(cfg, rows):
    return base.tree_init(api.abstract_cache(cfg, rows, 48), torch.Generator(), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tokens_are_the_same_with_spans_live_or_off(dtype):
    _, eng, prompts = _engine(5, dtype=dtype)
    off = eng.generate(prompts)
    on, spans = _trace(eng, prompts)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = eng.generate(prompts)
    assert spans and np.array_equal(off, on) and np.array_equal(off, profiled)


def test_only_the_cache_and_prefill_subtrees_take_device_events(monkeypatch):
    monkeypatch.setattr(telemetry, "_timing_stream", lambda: "stream")
    monkeypatch.setattr(telemetry, "_event", lambda stream: object())
    cfg, eng, prompts = _engine(3)
    _, spans = _trace(eng, prompts)
    ((root, children),) = ps.calls()
    timed = set()
    todo = [s for s in children[root.span_id] if s.name in ("serve.cache_init", "serve.prefill")]
    while todo:
        s = todo.pop()
        timed.add(s.span_id)
        todo.extend(children.get(s.span_id, ()))
    assert len(timed) == 2 + 4 + 8 * cfg.n_layers        # cache, prefill, its 4 + 8 a layer
    for s in spans:
        assert (s.device_time is not None) == (s.span_id in timed), s.name


def test_device_seconds_are_absent_on_the_cpu():
    _, eng, prompts = _engine(2)
    _, spans = _trace(eng, prompts)
    assert spans and all(s.device_s is None and "device_s" not in s.as_dict() for s in spans)
    rec = dataclasses.replace(spans[0], device_time=0.25)
    assert rec.device_s == 0.25 and rec.as_dict()["device_s"] == 0.25


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_span_brackets_its_host_and_device_events_within_50us():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.randn(8, device="cuda").sum().item()            # CUDA initialised first
    rec, events = _bracket("cuda", 0.0)
    assert events and any(e.name() == "aten::mm" for e in events)
    for e in events:
        assert rec.start_ns - 50_000 <= e.start_ns(), (e.name(), rec.start_ns - e.start_ns())
        assert e.start_ns() + e.duration_ns() <= rec.end_ns + 50_000, e.name()
    assert rec.device_s is not None and rec.device_s > 0
