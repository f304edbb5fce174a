"""The readers of the program's spans (`metrics/_program_spans.py` and the
four `program_span` metrics that use it), from span trees built by hand;
and on the card, the spans of a prefill at the cell's widths.

The card case serves 16 prompts of 2,048 tokens at mamba2-2.7b's widths,
cut to 8 layers, through the `ssd_scan` kernel: its prefill's children
(embedding, layers, head, cache stack, sync) cover the prefill's device
time to within 3%, its tokens are the same with the spans live as with
them off, and the decode steps' spans carry no device time. Run it on the chip with

    python -m pytest -q -m cuda gpubench/tests/test_gpubench_spans.py
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import core

ROOT = Path(__file__).resolve().parents[2]
CELL = "mamba2-2.7b.long_prompt"


def _reader(name: str):
    return core.load_module(ROOT / "gpubench" / "metrics" / f"{name}.py").read


class _Tree:
    """Span records built by hand, as the registry would hold them."""

    def __init__(self):
        self.records = []
        self._ids = 0

    def add(self, name, parent=None, host=0.0, device=None, **attrs):
        from repro_torch.netgen.telemetry import SpanRecord
        self._ids += 1
        rec = SpanRecord(trace_id=parent.trace_id if parent else self._ids, span_id=self._ids,
                         parent_id=parent.span_id if parent else None, name=name,
                         start_unix=1.0, duration_s=host, attrs=attrs, thread="main",
                         device_time=device)
        self.records.append(rec)
        return rec


@pytest.fixture
def tree(monkeypatch):
    from repro_torch.netgen import telemetry
    t = _Tree()
    monkeypatch.setattr(telemetry, "get_registry",
                        lambda: type("R", (), {"spans": lambda self: list(t.records)})())
    return t


def _run(arch=None):
    arch = arch or json.loads((ROOT / "gpubench/configs/mamba2-2.7b.json").read_text())["arch"]
    ctx = core.Context(cell={"name": CELL}, config={"arch": arch}, traffic={}, limits={},
                       reference=None, seed=1, seconds=1.0, trace=True,
                       device=torch.device("cpu"), t_start=time.time())
    return core.Run(ctx)


def _call(t, rows=16, length=1024, new=3, prefill_dev=10.0, steps=()):
    """One `serve.generate` tree: a prefill of one layer whose spans take
    in_proj 2 (cast 0.5), ssd 1, out_proj 1.5 (cast 0.25), conv 3 device
    seconds and a head 0.5; decode steps of (host s, sync host s)."""
    root = t.add("serve.generate", rows=rows, length=length, new=new)
    t.add("serve.cache_init", root, device=0.004, bytes=1)
    pre = t.add("serve.prefill", root, device=prefill_dev)
    lay = t.add("model.layer", pre, device=8.5)
    ip = t.add("mixer.in_proj", lay, device=2.0)
    t.add("weights.cast", ip, device=0.5, bytes=2)
    t.add("mixer.conv", lay, device=3.0)
    t.add("mixer.ssd", lay, device=1.0)
    op = t.add("mixer.out_proj", lay, device=1.5)
    t.add("weights.cast", op, device=0.25, bytes=2)
    t.add("model.head", pre, device=0.5)
    for i, (host, sync) in enumerate(steps):
        st = t.add("serve.decode_step", root, host=host, step=i)
        t.add("model.layer", st, host=host - sync)
        t.add("serve.sync", st, host=sync)
    return root


NAMES = ("prefill_glue_share", "mixer_gemm_roofline", "decode_host_share", "cache_init_ms")


@pytest.mark.parametrize("name", NAMES)
def test_readers_say_nothing_without_serving_spans(tree, name):
    assert _reader(name)(_run()) is None
    tree.add("netgen.compile")                 # another root: not the served LM's
    assert _reader(name)(_run()) is None


def test_glue_share_nets_the_casts_out_of_the_gemms(tree):
    _call(tree)
    _call(tree, prefill_dev=20.0)
    # work a prefill: (2 - 0.5) + (1.5 - 0.25) + 1 + head 0.5 = 4.25
    assert _reader("prefill_glue_share")(_run()) == pytest.approx(
        100 * (30.0 - 2 * 4.25) / 30.0)


def test_gemm_roofline_is_the_bound_over_the_net_gemm_time(tree):
    _call(tree, rows=16, length=1024)
    _call(tree, rows=4, length=2048)
    arch = _run().arch
    d, di = arch["d_model"], 2 * arch["d_model"]
    n_in = 2 * di + 2 * arch["ssm_groups"] * arch["ssm_state"] + di // arch["ssm_headdim"]
    assert n_in == 10576

    def bound(M):
        return sum(max(2 * M * K * N / 989e12, 2 * (M * K + K * N + M * N) / 3.35e12)
                   for K, N in ((d, n_in), (di, d)))
    # the GEMMs' device s a prefill, net of their casts: (2 - 0.5) + (1.5 - 0.25)
    want = 100 * arch["n_layers"] * (bound(16 * 1024) + bound(4 * 2048)) / (2 * 2.75)
    assert _reader("mixer_gemm_roofline")(_run()) == pytest.approx(want)


def test_decode_host_share_leaves_out_the_wait_for_tokens(tree):
    _call(tree, steps=[(0.1, 0.02), (0.1, 0.03)])
    _call(tree, steps=[(0.2, 0.05)])
    assert _reader("decode_host_share")(_run()) == pytest.approx(
        100 * (0.4 - 0.1) / 0.4)


def test_cache_init_is_the_mean_device_ms_a_call(tree):
    _call(tree)
    _call(tree)
    assert _reader("cache_init_ms")(_run()) == pytest.approx(4.0)


def test_device_readers_say_nothing_on_the_cpu(tree):
    root = tree.add("serve.generate", rows=1, length=8, new=2)
    tree.add("serve.cache_init", root)
    tree.add("serve.prefill", root)
    st = tree.add("serve.decode_step", root, host=0.1, step=0)
    tree.add("serve.sync", st, host=0.05)
    for name in ("prefill_glue_share", "mixer_gemm_roofline", "cache_init_ms"):
        assert _reader(name)(_run()) is None
    assert _reader("decode_host_share")(_run()) == pytest.approx(50.0)


@pytest.mark.cuda
def test_card_prefill_children_cover_its_device_time_and_tokens_hold():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gpubench import weights
    from repro_torch.models import api
    from repro_torch.models.base import ArchConfig
    from repro_torch.netgen import telemetry
    from repro_torch.serve.engine import Engine, ServeConfig

    config = json.loads((ROOT / "gpubench/configs/mamba2-2.7b.json").read_text())
    arch = dict(config["arch"], n_layers=8)
    cfg = ArchConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})
    dev = torch.device("cuda", 0)
    w = weights.draw(api.abstract_params(cfg), config["init"], 2 ** 31 + 11, dev)
    eng = Engine(cfg, w, ServeConfig(max_len=2052, max_new_tokens=3), device=dev)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (16, 2048)).astype(np.int32)
    eng.generate(prompts)
    off = eng.generate(prompts)
    telemetry.reset()
    telemetry.enable()
    try:
        on = eng.generate(prompts)
    finally:
        telemetry.disable()
    torch.cuda.synchronize()
    spans = telemetry.get_registry().spans()
    telemetry.reset()
    assert np.array_equal(off, on)
    (pre,) = [s for s in spans if s.name == "serve.prefill"]
    kids = [s for s in spans if s.parent_id == pre.span_id]
    assert len(kids) == 8 + 4
    covered = sum(s.device_s for s in kids)
    assert abs(covered - pre.device_s) <= 0.03 * pre.device_s, (covered, pre.device_s)
    by_id = {s.span_id: s for s in spans}

    def top(s):                           # the child of serve.generate that holds `s`
        while by_id[s.parent_id].name != "serve.generate":
            s = by_id[s.parent_id]
        return s.name
    assert sum(s.name == "serve.decode_step" for s in spans) == 2
    for s in spans:                       # the decode steps' spans stamp the host alone
        host_only = s.name == "serve.generate" or top(s) == "serve.decode_step"
        assert (s.device_s is None) == host_only, s.name
