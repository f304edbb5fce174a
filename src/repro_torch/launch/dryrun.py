"""Dry run of every (arch x shape) cell over a 256- or 512-rank world.

    python -m repro_torch.launch.dryrun --mesh single_pod [--arch A] [--shape S]
    python -m repro_torch.launch.dryrun --mesh multi_pod --arch qwen2-72b [--out PATH]

Counterpart of `repro/launch/dryrun.py`. The reference lowers and
compiles each cell's step for 512 forced host devices and reads XLA's
cost and memory analyses. The port opens a process group of the `fake`
backend (`open_fake_world`: 256 ranks for `single_pod`, 512 for
`multi_pod`, all in this process; a collective moves nothing), builds
the production mesh over it on the `meta` device, and runs one train,
prefill or decode step on storage-free tensors under the counting mode
(`launch/cost.py`), which sees every op of every layer: rank 0's FLOPs,
bytes, collective bytes and peak memory. As the reference's analysis
lowerings do, `analyze_cell` counts a step that runs flash attention at
two depths and extends the counts along their line to the config's
depth, exactly: they are linear in n_layers (`--no-analysis` counts the
full depth instead; the extended live high-water mark is an estimate).
No inner-scan correction is added: the counter sees every flash block
and SSD chunk, and the `ssd_scan` kernel reports its own work.

What a rank runs is what the port runs: a train step is data parallel
over the data axes and refuses a model axis above 1 (`train/step.py`,
ROADMAP.md A.7), which the sweep records as `{"ok": false, "error": ...}`
and goes on; a prefill or decode step takes its rank's rows of the
batch (all of them when the data ranks do not divide it) and runs
them whole, parameters replicated, so under model = 16 each rank does
its data group's whole work. On `meta` a data-parallel MoE layer cannot
read how many pairs each expert keeps and sizes its buffer at the
capacity (`layers/moe.py`); the cell's record says so (`moe_rows`).
Prefill sends every SSD through the `ssd_scan` kernel, as serving does.

`--serve-opt` serves from a bf16 copy of the parameters with the
reference's `fsdp` rule cleared. Records go to `build/dryrun_<mesh><tag>.json`
under the repo root, or to `--out`; a cell already recorded `ok` there is
skipped unless `--force`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import specs as specs_lib
from repro_torch.launch import cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import FAKE_BACKEND, make_production_mesh
from repro_torch.models import api, runtime
from repro_torch.models.base import ParamInfo, tree_init, tree_map, tree_sds
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.serve.engine import make_serve_step
from repro_torch.train import step as step_lib

__all__ = ["open_fake_world", "build_step", "count_step", "analysis_layers", "analyze_cell",
           "run_cell", "main"]

ROOT = Path(__file__).resolve().parents[3]
MESHES = {"single_pod": 256, "multi_pod": 512}


def open_fake_world(world: int) -> None:
    """A process group of `world` ranks in this process, this one rank 0,
    on the `fake` backend (torch's `FakeProcessGroup`: collectives return
    at once and move nothing). Returns at once when one is open."""
    if dist.is_initialized():
        if str(dist.get_backend()) != FAKE_BACKEND or dist.get_world_size() != world:
            raise RuntimeError(f"a process group is open ({dist.get_backend()}, "
                               f"{dist.get_world_size()} ranks); the dry run needs a "
                               f"{FAKE_BACKEND} world of {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world)


def _rules_for(mesh) -> dict:
    if mesh is None or "pod" in mesh.shape:
        return {}                       # default rules already include pod
    return {"batch": ("data",)}


def _serve_params_tree(cfg, variant: dict):
    """Abstract serving params under a variant: optional dtype cast
    (fp32 master -> bf16 serving copy) and/or W8 int8 specialization."""
    if variant.get("quant"):
        from repro_torch.quantized.apply import abstract_quantized_params
        tree = abstract_quantized_params(cfg)
    else:
        tree = api.abstract_params(cfg)
    dt = variant.get("serve_dtype")
    if dt:
        def cast(i: ParamInfo) -> ParamInfo:
            if i.dtype == torch.float32 and len(i.shape) >= 2:
                return dataclasses.replace(i, dtype=getattr(torch, dt))
            return i
        tree = tree_map(cast, tree)
    return tree


def _materialize(tree, device: torch.device, seed: int = 0):
    """An abstract tree as storage-free tensors on `meta`, else made on
    `device` from one generator."""
    if device.type == "meta":
        return tree_sds(tree)
    return tree_init(tree, torch.Generator(device=device).manual_seed(seed), device)


def _batch(cfg, shape, device: torch.device) -> dict:
    """The step's inputs (specs_lib.input_specs): on `meta`, those; else
    zeros of their shapes and dtypes (valid token ids and positions)."""
    specs = specs_lib.input_specs(cfg, shape)
    if device.type == "meta":
        return specs
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def serve_rows(shape, mesh) -> int:
    """Rows of a serving batch one rank runs: its share over the data axes
    where they divide the batch, else the whole batch."""
    n = 1 if mesh is None else mesh.size(("pod", "data"))
    B = shape.global_batch
    return B // n if B % n == 0 else B


def build_step(cfg, shape, mesh=None, *, remat: str = "full", variant: dict | None = None,
               device="meta"):
    """One cell's step, ready to run: returns `run()`, which runs it once
    on inputs made here (so a counter sees them as arguments) under
    `mesh`, its rules and the variant's flags. `variant` is the
    reference's switchboard: {"flags": runtime flags, "rules": logical
    rule overrides, "serve_dtype": "bfloat16", "quant": True}."""
    variant = variant or {}
    device = torch.device(device)
    rules = dict(_rules_for(mesh))
    rules.update(variant.get("rules", {}))

    def under_mesh(fn):
        def run():
            with runtime.with_flags(**variant.get("flags", {})), (
                    shd.use_mesh(mesh, rules) if mesh is not None else contextlib.nullcontext()):
                return fn()
        return run

    if shape.kind == "train":
        oc = adamw.OptConfig()
        train_step = step_lib.make_train_step(cfg, shape, oc, remat=remat)
        state = _materialize(step_lib.abstract_state(cfg), device)
        batch = _batch(cfg, shape, device)
        return under_mesh(lambda: train_step(state, batch))
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(shape.kind)
    rows = serve_rows(shape, mesh)
    local = dataclasses.replace(shape, global_batch=rows)
    params = _materialize(_serve_params_tree(cfg, variant), device)
    cache = _materialize(api.abstract_cache(cfg, rows, shape.seq_len), device)
    batch = _batch(cfg, local, device)
    if shape.kind == "prefill":
        return under_mesh(lambda: api.prefill(cfg, params, batch, cache, use_kernel=True))
    serve_step = make_serve_step(cfg)
    return under_mesh(lambda: serve_step(params, cache, batch["tokens"], batch["pos"]))


def count_step(run) -> cost.Counter:
    """Run a built step once under a fresh counter; the counter."""
    with cost.Counter() as counter:
        run()
    return counter


def analysis_layers(cfg) -> tuple:
    """(L1, L2): the layer counts `analyze_cell` counts a cell at (whole
    attention groups for the hybrid family)."""
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every
    return 1, 2


def _extend(a, b, k: float):
    """a + k (b - a), leaf by leaf over nested dicts of numbers."""
    if isinstance(a, dict):
        return {key: _extend(a[key], b[key], k) for key in a}
    return a + k * (b - a)


def analyze_cell(cfg, shape, mesh, *, remat: str = "full", variant: dict | None = None,
                 device="meta") -> dict:
    """Per-rank totals of a cell's step at its full depth. A step that runs
    flash attention (a prefill or train step of 2048 tokens or more with
    attention layers: thousands of block ops a layer) is counted at L1
    and L2 layers and extended along the line through them: its FLOPs,
    bytes, collectives and argument bytes are exactly linear in n_layers
    (the layer loops repeat the same ops; held by
    tests/test_torch_roofline.py), so those totals are exact, and a
    32k-token step of 80 layers costs two short counts. The live
    high-water mark is linear only once the layers' retained outputs
    outweigh the head's transients, so its extension is an estimate
    (`extended` True). Every other step is counted at its full depth. The
    reference's inner-scan corrections per rank go beside the totals, for
    comparison only."""
    def measure(n_layers):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        counter = count_step(build_step(c, shape, mesh, remat=remat, variant=variant,
                                        device=device))
        s = counter.summary()
        s["breakdown"] = {k: s["breakdown"].get(k, 0) for k in (*rl.KINDS, "_num_ops")}
        return s

    L1, L2 = analysis_layers(cfg)
    flash = rl.flash_correction(cfg, batch=1, seq=shape.seq_len, kind=shape.kind)["flops"]
    if cfg.n_layers <= L2 or not flash:
        out = measure(cfg.n_layers)
        out["extended"] = False
    else:
        a, b = measure(L1), measure(L2)
        if a["kernels"].keys() != b["kernels"].keys():
            raise RuntimeError(f"kernels differ between {L1} and {L2} layers")
        out = _extend(a, b, (cfg.n_layers - L1) / (L2 - L1))
        out["extended"] = True
    batch = shape.global_batch // shape.accum if shape.kind == "train" else shape.global_batch
    scale = shape.accum if shape.kind == "train" else 1
    corr = rl.inner_scan_corrections(cfg, batch=batch, seq=shape.seq_len, kind=shape.kind)
    chips = _chips(mesh)
    out["reference_corrections_per_device"] = {k: scale * v / chips for k, v in corr.items()}
    return out


def _chips(mesh) -> int:
    return 1 if mesh is None else mesh.size(tuple(mesh.shape))


def run_cell(cfg, shape, mesh, *, remat: str = "full", analysis: bool = True,
             verbose: bool = True, variant: dict | None = None, device="meta") -> tuple:
    """Count one cell's step. Returns (record, meta). With `analysis`
    (the default) the totals come from `analyze_cell`; without, from one
    count of the step at its full depth (slow for long sequences: every
    flash block of every layer is an op to run)."""
    t0 = time.time()
    if analysis:
        eff = analyze_cell(cfg, shape, mesh, remat=remat, variant=variant, device=device)
    else:
        eff = count_step(build_step(cfg, shape, mesh, remat=remat, variant=variant,
                                    device=device)).summary()
    count_s = time.time() - t0
    chips = _chips(mesh)
    record = rl.Roofline(
        arch=cfg.name,
        shape=shape.name,
        mesh="x".join(str(s) for s in (mesh.shape.values() if mesh else (1,))),
        chips=chips,
        flops_per_device=eff["flops"],
        bytes_per_device=eff["bytes"],
        collective_bytes=eff["coll"],
        collective_breakdown=eff["breakdown"],
        model_flops=rl.model_flops(cfg, shape),
        peak_mem_per_device=float(eff["peak_bytes"]),
    )
    meta = {
        "count_s": count_s,
        "arg_bytes": eff["arg_bytes"],
        "peak_live_bytes": eff["peak_live"],    # an estimate when extended
        "aten_ops": eff["ops"],
        "kernels": eff["kernels"],
        "rows_per_rank": (shape.global_batch if shape.kind == "train"
                          else serve_rows(shape, mesh)),
    }
    if analysis:
        meta["extended_from_layers"] = analysis_layers(cfg) if eff["extended"] else None
        meta["reference_corrections_per_device"] = eff["reference_corrections_per_device"]
    data_ranks = 1 if mesh is None else mesh.size(("pod", "data"))
    if (cfg.family == "moe" and shape.kind == "train" and data_ranks > 1
            and torch.device(device).type == "meta"):
        meta["moe_rows"] = "capacity (meta: the kept pairs per expert cannot be read)"
    if verbose:
        print(f"  counted: args={meta['arg_bytes']/2**30:.2f}GiB "
              f"live peak={meta['peak_live_bytes']/2**30:.2f}GiB "
              f"-> peak/device={record.peak_mem_per_device/2**30:.3f}GiB")
        print(f"  per-step/device: flops={record.flops_per_device:.3e} "
              f"bytes={record.bytes_per_device:.3e} "
              f"coll={record.collective_bytes:.3e} "
              f"({eff['breakdown'].get('_num_ops', 0)} coll ops, {meta['aten_ops']} aten ops)")
        print(f"  roofline: t_comp={record.t_compute*1e3:.2f}ms "
              f"t_mem={record.t_memory*1e3:.2f}ms "
              f"t_coll={record.t_collective*1e3:.2f}ms "
              f"bottleneck={record.bottleneck} "
              f"frac={record.roofline_fraction:.3f} "
              f"useful={record.useful_flops_ratio:.3f}")
    return record, meta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=sorted(MESHES), default="single_pod")
    ap.add_argument("--arch", default=None, help="run one arch only")
    ap.add_argument("--shape", default=None, help="run one shape only")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-analysis", action="store_true",
                    help="count each step at its full depth (no extension from L1, L2)")
    ap.add_argument("--serve-opt", action="store_true",
                    help="serve cells use a bf16 copy of the parameters, fsdp rule cleared")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help="JSON path (default build/dryrun_<mesh><tag>.json)")
    args = ap.parse_args(argv)

    open_fake_world(MESHES[args.mesh])
    mesh = make_production_mesh(multi_pod=(args.mesh == "multi_pod"), device="meta")
    out_path = Path(args.out) if args.out else ROOT / "build" / f"dryrun_{args.mesh}{args.tag}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    done: dict[str, dict] = {}
    if out_path.exists() and not args.force:
        done = {r["cell"]: r for r in json.loads(out_path.read_text())}

    cells = configs.all_cells()
    if args.arch:
        cells = [(c, s) for c, s in cells if c.name == args.arch]
    if args.shape:
        cells = [(c, s) for c, s in cells if s.name == args.shape]

    n_fail = 0
    t_sweep = time.time()
    for cfg, shape in cells:
        key = f"{cfg.name}/{shape.name}"
        if key in done and done[key].get("ok"):
            print(f"[skip] {key}")
            continue
        print(f"[cell] {key} on {args.mesh} "
              f"(B={shape.global_batch}, S={shape.seq_len}, {shape.kind})", flush=True)
        t0 = time.time()
        variant = None
        if args.serve_opt and shape.kind in ("prefill", "decode"):
            variant = {"serve_dtype": "bfloat16", "rules": {"fsdp": ()}}
        try:
            record, meta = run_cell(cfg, shape, mesh, remat=args.remat,
                                    analysis=not args.no_analysis, variant=variant)
            done[key] = {"cell": key, "ok": True, **record.as_dict(), **meta}
        except Exception as e:  # noqa: BLE001 - record and continue the sweep
            if not isinstance(e, NotImplementedError):
                traceback.print_exc()
                n_fail += 1
            done[key] = {"cell": key, "ok": False, "error": f"{type(e).__name__}: {e}"}
        print(f"  [{time.time()-t0:.1f}s total]", flush=True)
        out_path.write_text(json.dumps(list(done.values()), indent=1, default=float))

    ok = sum(1 for r in done.values() if r.get("ok"))
    print(f"\n== {ok}/{len(done)} cells OK ({n_fail} new failures) in "
          f"{time.time() - t_sweep:.1f}s -> {out_path}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
