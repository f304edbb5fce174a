"""Driver of a served LM: the port's `Engine.generate`, in a closed loop.

Set-up: the weights are drawn on the device from the seed
(`weights.draw`, the configuration's init rules) as float32 masters, and
one `Engine` (greedy, `eos_id` -1 so that no request stops early, its
cache sized for the longest prompt and its answer, every SSD through the
`ssd_scan` kernel) serves one batch of each of the mix's prompt lengths
to warm every shape the window uses. `setup_s` runs from the process's
start to the first timed batch.

The window: one client sends a batch of `rows` prompts to `generate`,
waits for its tokens, and sends the next, a whole cycle of the mix's
lengths at a time. It opens when the first timed batch starts and
closes when the cycle in flight at `--seconds` completes, so every seed
sends the same work and a stall stays inside the window.

With `--trace 1`, one more cycle runs after the window under
`torch.profiler`, each batch inside the harness's `gpubench.batch` span.

After the window (and the traced cycle): the peak of device memory is
read, the engine is freed, and the check runs (`check.py`) on the
seeded sample of the window's requests, with the configuration's
reference module. The weights the reference reads are the tensors the
engine was handed; a checksum of each leaf taken before the engine was
built must read the same again (`weights_changed`, limit 0), so a
program that wrote into them cannot pass its fault on to the reference.
What the check compared is kept in `Run.judged`, so that the control
(`tools/control.py`) reads the same requests of the same run.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from gpubench import check, core, trace, weights
from gpubench.traffic import Traffic

__all__ = ["run"]


def _arch_config(arch: dict):
    from repro_torch.models.base import ArchConfig
    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _serve(engine, prompts: np.ndarray, index: int, vocab: int, new: int):
    """One batch through the engine: (Batch, tokens, valid)."""
    t0 = time.perf_counter()
    out = engine.generate(prompts)
    t1 = time.perf_counter()
    stats = engine.stats
    rows, length = prompts.shape
    b = core.Batch(index, rows, length, t0, t1, stats["prefill_s"], list(stats["decode_s"]))
    valid = (out.shape == (rows, new) and len(b.decode_s) == new - 1
             and bool((out >= 0).all() and (out < vocab).all()))
    return b, out, valid


def run(ctx: core.Context) -> core.Run:
    from repro_torch.models import api
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = torch.device(ctx.device)
    r = core.Run(ctx)
    cfg = _arch_config(ctx.config["arch"])
    traffic = Traffic(ctx.traffic, cfg.vocab, ctx.seed)
    new = r.new_tokens = traffic.new_tokens
    w = weights.draw(api.abstract_params(cfg), ctx.config["init"], ctx.seed, dev)
    drawn = weights.checksum(w)
    engine = Engine(cfg, w, ServeConfig(max_len=traffic.max_len, max_new_tokens=new),
                    device=dev, use_kernel=True)
    for p in traffic.warm_prompts():
        engine.generate(p)
    _sync(dev)
    r.setup_s = time.time() - ctx.t_start

    prompts, served = {}, {}
    i, cycle = 0, 0
    t_open = time.perf_counter()
    while True:
        for length in traffic.cycle_lengths(cycle):
            p = traffic.prompts("window", i, length)
            b, out, valid = _serve(engine, p, i, cfg.vocab, new)
            r.batches.append(b)
            r.attempted += b.rows
            if valid:
                prompts[i], served[i] = p, out
            else:
                r.failed += b.rows
            i += 1
        cycle += 1
        if b.t1 - t_open >= ctx.seconds:
            break
    r.window_s = b.t1 - t_open

    if dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if ctx.trace:
        r.trace = _traced_cycle(engine, traffic, cycle, dev)
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    changed = [path for path, s in weights.checksum(w).items() if s != drawn[path]]
    if changed:
        print(f"gpubench: the program changed the weights it was handed: {changed}",
              file=sys.stderr)
    reqs = [(b.index, row, b.length) for b in r.batches if b.index in served
            for row in range(b.rows)]
    gap = math.inf
    if reqs:
        r.judged = {"arch": ctx.config["arch"], "weights": w,
                    "sample": traffic.check_sample(reqs), "prompts": prompts,
                    "served": served, "new": new, "device": dev}
        gap = check.served_gap(ctx.reference, **r.judged)
    limit = ctx.limits["gap"]
    r.checks["weights_changed"] = (len(changed), 0)
    r.checks["gap"] = (gap, limit)
    r.correct = r.failed == 0 and not changed and math.isfinite(gap) and gap <= limit
    return r


def _traced_cycle(engine, traffic: Traffic, cycle: int, dev) -> trace.Trace:
    """One cycle of the mix (the cycle after the window's) under the
    profiler, each batch in its `gpubench.batch` span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    done = []
    with profile(activities=acts) as prof:
        for j, length in enumerate(traffic.cycle_lengths(cycle)):
            p = traffic.prompts("trace", j, length)
            with record_function(trace.BATCH_SPAN):
                engine.generate(p)
            done.append((p.shape[0], length, list(engine.stats["decode_s"])))
        _sync(dev)
    return trace.reduce(prof, done)
