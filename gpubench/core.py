"""The harness: finds a cell's pieces by name, runs its driver, reads its
metrics and prints the result.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kind of entry point is a file of its own, found by the name
that `BENCHMARK.json` gives it:

- `configs/<config>.json`: the configuration's `file`, as listed in
  `BENCHMARK.json` (sizes, init rules, the names of its driver and of
  its reference);
- `reference/<reference>.py`: the configuration's plain reference,
  `logits(arch, weights, tokens, last, precision=)`, and its count of a
  prefill's work, `prefill_flops(arch, rows, length)`;
- `traffic/<traffic>.json`: the mix's parameters (`traffic.py`);
- `limits/<cell>.json`: each number the check compares, and its limit;
- `drivers/<driver>.py`: `run(ctx) -> Run`, the entry point of one kind;
- `metrics/<metric>.py`: `read(run) -> float | None`, one reader for each
  end-to-end and per-layer metric. A reader that finds nothing to read
  returns None, and the metric is left out of the line.

So a later cell, configuration, mix or metric adds files and entries and
edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOT", "Batch", "Run", "Context", "load_manifest", "cell_metrics",
           "execute", "result_line", "forbidden_modules", "main"]

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Batch:
    index: int
    rows: int
    length: int
    t0: float                  # host clock at the call into the engine
    t1: float                  # host clock at its return
    prefill_s: float           # the engine's stats
    decode_s: list


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    reference: object          # the configuration's reference module
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float             # process start, on time.time()
    root: Path = ROOT          # the checkout: BENCHMARK.json and gpubench/


@dataclasses.dataclass
class Run:
    ctx: Context
    setup_s: float = 0.0
    batches: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    new_tokens: int = 0
    attempted: int = 0
    failed: int = 0
    trace: object = None
    memory_peak_bytes: int = 0
    checks: dict = dataclasses.field(default_factory=dict)   # name: (value, limit)
    correct: bool = False
    judged: dict = dataclasses.field(default_factory=dict)   # what the check compared

    @property
    def arch(self) -> dict:
        return self.ctx.config["arch"]


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file, whatever characters its name has."""
    spec = importlib.util.spec_from_file_location(f"gpubench_{path.parent.name}_{path.stem}",
                                                  path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries that cell reports."""
    return [m for m in manifest[kind] if "workloads" not in m or cell in m["workloads"]]


def context(manifest: dict, cell_name: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, root: Path = ROOT) -> Context:
    """The cell's pieces, read from their files under `root`."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = root / BENCH_DIR.name
    config = _load_json(root / configs[cell["config"]]["file"])
    traffic = _load_json(bench / "traffic" / f"{cell['traffic']}.json")
    limits = _load_json(bench / "limits" / f"{cell_name}.json")
    reference = load_module(bench / "reference" / f"{config['reference']}.py")
    return Context(cell, config, traffic, limits, reference, seed, seconds, trace, device,
                   t_start, root)


def execute(manifest: dict, ctx: Context) -> tuple[Run, dict]:
    """Run the cell's driver, then read its metrics: the end-to-end ones,
    or with `ctx.trace` the per-layer ones. Returns (run, {name: entry})."""
    bench = ctx.root / BENCH_DIR.name
    driver = load_module(bench / "drivers" / f"{ctx.config['driver']}.py")
    run = driver.run(ctx)
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(manifest, ctx.cell["name"], kind):
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return run, metrics


def device_entry(run: Run) -> dict:
    import torch
    dev = torch.device(run.ctx.device)
    gpu = dev.type == "cuda"
    out = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(dev) if gpu else "cpu",
           "count": int(run.ctx.cell["chips"]) if gpu else 0,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s
        out["window_s"] = run.trace.window_s
    return out


def result_line(run: Run, metrics: dict) -> dict:
    line = {"correct": bool(run.correct), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_entry(run)}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (`repro_torch` is not `repro`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    manifest = load_manifest()
    cells = {c["name"]: c for c in manifest["workloads"]}
    if args.workload not in cells:
        print(f"gpubench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s), found {have}; "
              "nothing is run on the CPU", file=sys.stderr)
        return 3
    ctx = context(manifest, args.workload, args.seed, float(args.seconds), bool(args.trace),
                  torch.device("cuda", 0), t_start)
    run, metrics = execute(manifest, ctx)
    loaded = forbidden_modules()
    if loaded:
        print(f"gpubench: forbidden modules loaded in the run: {loaded}", file=sys.stderr)
        return 4
    n_req = sum(b.rows for b in run.batches)
    steps = sum(len(b.decode_s) for b in run.batches)
    print(f"gpubench: {args.workload} seed {args.seed}: window {run.window_s:.3f} s, "
          f"{len(run.batches)} batches, {n_req} requests (time-to-first-token samples), "
          f"{steps} decode steps; set-up {run.setup_s:.3f} s")
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(run, metrics)), flush=True)
    return 0
