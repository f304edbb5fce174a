"""Readings from which a cell's limit is set: the program's gap on many
seeds and the control's on some, in one process.

    python3 gpubench/tools/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out readings.jsonl]

For each seed the cell's own driver runs (`core.execute`) with a window
of one cycle of the mix, at the cell's own rows and lengths: the same
set-up, engine, batches and check as a benchmark run, whose sample of
the window's requests (`Run.judged`) the check compared with the
reference. On the control seeds the fp8 reference's first choices are
read on that same sample (`check.control_gap`). Each seed prints one
JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(cell: str, seeds: list, control_seeds: list, device=None):
    """Yield {"seed", "gap", "control_gap" (or None), "correct", ...} per
    seed."""
    import torch
    from gpubench import check, core

    dev = torch.device(device or "cuda")
    manifest = core.load_manifest()
    for seed in seeds:
        t0 = time.time()
        ctx = core.context(manifest, cell, seed, 0.0, False, dev, t0)
        run, _ = core.execute(manifest, ctx)
        low = None
        if seed in control_seeds and run.judged:
            low = check.control_gap(ctx.reference, **run.judged)
        rec = {"cell": cell, "seed": seed, "gap": run.checks["gap"][0], "control_gap": low,
               "correct": run.correct, "requests": len(run.judged.get("sample", ())),
               "seconds": time.time() - t0}
        del run
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for rec in readings(args.workload, seeds, ctl):
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
