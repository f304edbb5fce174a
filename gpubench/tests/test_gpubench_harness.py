"""The harness end to end on the CPU at a tiny size: a sound run is
correct, each fault planted under the timed path makes `correct` false,
and a run that finds no card prints no result.

The tiny run skips the harness's look for a card (`core.execute` with a
CPU device) and drives everything else: the set-up, the closed-loop
window, the traced cycle, the metric readers and the check, with the
cell's own configuration file, init rules and limits, cut to the port's
`configs.smoke` sizes, and a mix of two short lengths.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import core

ROOT = Path(__file__).resolve().parents[2]
TINY_TRAFFIC = {"loop": "closed", "clients": 1, "rows": 3, "prompt_lengths": [32, 64],
                "new_tokens": 4, "check_requests": 6}
CELLS = ["mamba2-2.7b.long_prompt", "mamba2-2.7b.short_prompt"]


def _tiny_ctx(cell: str, trace: bool = False, seed: int = 2 ** 31 + 7,
              seconds: float = 0.2) -> core.Context:
    from repro_torch import configs
    manifest = core.load_manifest()
    ctx = core.context(manifest, cell, seed, seconds, trace, torch.device("cpu"), time.time())
    small = dataclasses.replace(configs.smoke(ctx.config["arch"]["name"]),
                                tie_embeddings=ctx.config["arch"]["tie_embeddings"])
    arch = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(small).items()}
    return dataclasses.replace(ctx, config=dict(ctx.config, arch=arch), traffic=TINY_TRAFFIC)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_reports_its_metrics(cell):
    manifest = core.load_manifest()
    run, metrics = core.execute(manifest, _tiny_ctx(cell))
    assert run.correct and run.failed == 0 and run.attempted % 3 == 0
    assert len(run.batches) % 2 == 0                   # whole cycles
    assert set(metrics) == {"total_tokens_per_s", "ttft_p95_ms", "setup_s"}
    value, limit = run.checks["gap"]
    assert 0 <= value <= limit and run.checks["weights_changed"] == (0, 0)
    line = core.result_line(run, metrics)
    assert list(line)[-1] == "check" and line["check"]["gap"]["limit"] == limit


def test_tiny_traced_run_reads_the_host_spans():
    manifest = core.load_manifest()
    run, metrics = core.execute(manifest, _tiny_ctx(CELLS[1], trace=True))
    assert run.correct and run.trace is not None
    assert run.trace.decode_steps == 2 * 3 and run.trace.window_s > 0
    assert "decode_step_ms" in metrics
    # no device in the CPU trace: the device readers find nothing and say nothing
    for name in ("ssd_scan_roofline", "launches_per_decode_step", "idle_share",
                 "prefill_mfu"):
        assert name not in metrics


def _decode_keeps_state(monkeypatch):
    from repro_torch.models import api
    real = api.decode_step

    def stale(cfg, params, tokens, pos, cache, extras=None):
        logits, _ = real(cfg, params, tokens, pos, cache, extras)
        return logits, cache
    monkeypatch.setattr(api, "decode_step", stale)


def _half_batch(monkeypatch):
    from repro_torch.models import api
    real = api.prefill

    def half(cfg, params, batch, cache, *, use_kernel=False):
        B = batch["tokens"].shape[0]
        idx = torch.arange(B) % ((B + 1) // 2)
        keep = {k: v[: (B + 1) // 2] for k, v in batch.items()}
        part = _rows(cache, torch.arange((B + 1) // 2))
        logits, new = real(cfg, params, keep, part, use_kernel=use_kernel)
        return logits[idx], _rows(new, idx)
    monkeypatch.setattr(api, "prefill", half)


def _rows(cache, idx):
    """Rows `idx` of a cache (its batch dim is dim 1, after the layers or
    sites)."""
    if isinstance(cache, dict):
        return {k: _rows(v, idx) for k, v in cache.items()}
    return cache.index_select(1, idx.to(cache.device))


def _token_altered(monkeypatch):
    from repro_torch.serve import engine
    real = engine.make_serve_step

    def altered(cfg):
        step = real(cfg)

        def serve_step(params, cache, tokens, pos):
            nxt, cache = step(params, cache, tokens, pos)
            return (nxt + 1) % cfg.vocab, cache
        return serve_step
    monkeypatch.setattr(engine, "make_serve_step", altered)


@pytest.mark.parametrize("fault", [_decode_keeps_state, _half_batch, _token_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    manifest = core.load_manifest()
    # one cycle, whose six requests are all in the check's sample
    run, _ = core.execute(manifest, _tiny_ctx(cell, seconds=0.0))
    assert len(run.batches) == 2
    value, limit = run.checks["gap"]
    assert not run.correct and value > limit


def test_a_program_that_writes_into_its_weights_is_not_correct(monkeypatch):
    """The reference reads the tensors the engine was handed: a prefill
    that scales a weight in place would pass its own fault on to the
    reference, so the checksum taken before the engine was built fails
    the run."""
    from repro_torch.models import api
    real = api.prefill

    def writes(cfg, params, batch, cache, *, use_kernel=False):
        params["final_norm"]["scale"].mul_(1.5)
        return real(cfg, params, batch, cache, use_kernel=use_kernel)
    monkeypatch.setattr(api, "prefill", writes)
    run, _ = core.execute(core.load_manifest(), _tiny_ctx(CELLS[0], seconds=0.0))
    assert run.checks["weights_changed"] == (1, 0)
    assert not run.correct


def test_a_gap_that_is_not_finite_fails():
    from gpubench import check

    class Ref:
        @staticmethod
        def logits(arch, weights, tokens, last, precision="fp32"):
            out = torch.zeros(tokens.shape[0], last, 8)
            out[0, 0, 0] = float("nan")
            return out
    prompts = {0: np.zeros((2, 5), dtype=np.int32)}
    served = {0: np.zeros((2, 3), dtype=np.int64)}
    sample = [(0, 0, 5), (0, 1, 5)]
    assert check.served_gap(Ref, {}, {}, sample, prompts, served, 3, "cpu") == float("inf")
    assert check.control_gap(Ref, {}, {}, sample, prompts, served, 3, "cpu") == float("inf")


def test_no_card_no_result():
    """On a machine without CUDA the run exits non-zero and prints no
    result line (skipped where PyTorch sees a CUDA device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0],
                        "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.lstrip().startswith("{") for line in p.stdout.splitlines())
    assert "CUDA" in p.stderr


def test_same_seed_same_inputs_and_cycles_hold_every_length():
    from gpubench.traffic import Traffic
    spec = json.loads((ROOT / "gpubench" / "traffic" / "long_prompt.json").read_text())
    a, b = Traffic(spec, 50288, 2 ** 33 + 5), Traffic(spec, 50288, 2 ** 33 + 5)
    assert np.array_equal(a.prompts("window", 3, 1024), b.prompts("window", 3, 1024))
    for c in range(5):
        assert sorted(a.cycle_lengths(c)) == sorted(spec["prompt_lengths"])
    other = Traffic(spec, 50288, 2 ** 33 + 6)
    assert not np.array_equal(a.prompts("window", 3, 1024), other.prompts("window", 3, 1024))
    reqs = [(i, r, spec["prompt_lengths"][i % 4]) for i in range(8) for r in range(16)]
    sample = a.check_sample(reqs)
    assert len(sample) == 64 and max(s[2] for s in sample) == 4096
