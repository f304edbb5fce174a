"""Serving step times of the port's LMs in two source trees, side by side
on one card.

    python scripts/lm_serve_ab.py --tree A_DIR --tree B_DIR \
        [--arch qwen1.5-4b ...] [--repeats 10] [--json OUT]

Each tree is a checkout of the repo (its `src/` holds `repro_torch`). The
trees run in the order A, B, B, A, each in a fresh process with that
tree's `src/` first on the path, so a difference that drifts with the
card's clock or temperature shows as a difference between the two A (or
two B) runs. For each `--arch`, at its published width with random
weights (seed 0, the fp32 checkpoint, the config's compute dtype), the
child times one 4 x 512 prefill and one decode step at position 512:

  wall_ms   median host wall of `--repeats` calls, each synchronized
            (what the engine's timers see);
  busy_ms   the device time of one call from `torch.profiler` (sum of
            its kernels' spans);
  launches  that call's kernel launches.

Every model runs `use_kernel=False`, so no kernel is built. Prints one
line per run and model, then the medians per tree; `--json` writes all
of it. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARCHS = ("qwen1.5-4b", "llama3.2-3b", "granite-moe-1b-a400m", "mamba2-2.7b", "zamba2-2.7b")
BATCH, PROMPT, SEED = 4, 512, 0


def _profile(fn) -> tuple[float, int]:
    """(device busy ms, kernel launches) of one call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def _wall_ms(fn, repeats: int) -> float:
    import torch
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def child(archs: list[str], repeats: int) -> None:
    """Time each arch in this process's tree; one JSON line per arch."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api, base

    dev = torch.device("cuda")
    for name in archs:
        cfg = configs.get_config(name)
        with torch.inference_mode():
            params = base.tree_init(api.abstract_params(cfg),
                                    torch.Generator(device=dev).manual_seed(SEED), dev)
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=g, device=dev)
            cache = base.tree_init(api.abstract_cache(cfg, BATCH, PROMPT + 1),
                                   torch.Generator(device=dev), dev)
            logits, state = api.prefill(cfg, params, {"tokens": tokens}, cache)
            nxt = logits.argmax(-1)[:, None]
            pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=dev)
            calls = {"prefill": lambda: api.prefill(cfg, params, {"tokens": tokens}, cache),
                     "decode_step": lambda: api.decode_step(cfg, params, nxt, pos, state)}
            rec = {"arch": name}
            for what, fn in calls.items():
                fn()
                wall = _wall_ms(fn, repeats)
                busy, launches = _profile(fn)
                rec[what] = {"wall_ms": wall, "busy_ms": busy, "launches": launches}
        print(json.dumps(rec), flush=True)
        del params, cache, state, logits
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout of the repo; give two (A, then B)")
    ap.add_argument("--arch", action="append", choices=ARCHS)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = args.arch or list(ARCHS)
    if args.child:
        child(archs, args.repeats)
        return 0
    if len(args.tree) != 2:
        ap.error("give --tree twice")
    a, b = (str(Path(t).resolve()) for t in args.tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    runs = []
    for label, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "--tree", tree,
               "--repeats", str(args.repeats)] + [f"--arch={x}" for x in archs]
        out = subprocess.run(cmd, env=env, cwd=tree, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            raise SystemExit(f"run {label} ({tree}) exited {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                rec = dict(json.loads(line), tree=label)
                runs.append(rec)
                print(f"{label} {rec['arch']}: " + "; ".join(
                    f"{w} wall {rec[w]['wall_ms']:.3f} ms, busy {rec[w]['busy_ms']:.3f} ms, "
                    f"{rec[w]['launches']} launches" for w in ("prefill", "decode_step")),
                    flush=True)
    summary = {}
    for name in archs:
        for w in ("prefill", "decode_step"):
            for label in "AB":
                rs = [r[w] for r in runs if r["arch"] == name and r["tree"] == label]
                summary.setdefault(name, {}).setdefault(w, {})[label] = {
                    k: statistics.median(r[k] for r in rs)
                    for k in ("wall_ms", "busy_ms", "launches")}
    for name, ws in summary.items():
        print(f"{name}: " + "; ".join(
            f"{w} A/B wall {v['A']['wall_ms']:.3f}/{v['B']['wall_ms']:.3f} ms, busy "
            f"{v['A']['busy_ms']:.3f}/{v['B']['busy_ms']:.3f} ms, launches "
            f"{v['A']['launches']:.0f}/{v['B']['launches']:.0f}" for w, v in ws.items()))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card.strip(), "trees": {"A": a, "B": b},
                                               "runs": runs, "medians": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
