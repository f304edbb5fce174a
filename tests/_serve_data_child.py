"""One rank of the gloo worlds that tests/test_torch_serve_data.py starts.

    python tests/_serve_data_child.py <rank> <world> <dir>

Imports torch, numpy and `repro_torch` only: the parent hands the
weights (fp32, or the reference's W8 tree), prompts and modality inputs
over as <dir>/<case>.npz, the cases as <dir>/cases.json. The process
group comes from a `FileStore` in <dir>. The mesh is (data 2, model
world / 2) under the serving rules. For each case the rank runs
`Engine.generate` in fp32 on the CPU twice, unmeshed and under the mesh,
recording each MoE layer's routing (every token's expert ids, sorted)
and dropped pairs per call, and the batch rows of the cache each prefill
is handed. It writes the tokens, those records, its coordinates and the
fallbacks to <dir>/rank<rank>.npz.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from _tp_child import _tree, case_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import moe
from repro_torch.models import api, base, convert
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.serve.engine import Engine, ServeConfig

DATA = 2


@contextlib.contextmanager
def recorded():
    """Within: each MoE call's sorted expert ids and dropped pairs, and the
    cache rows each prefill is handed."""
    seen = {"ids": [], "drops": [], "rows": []}
    route, dispatch, prefill = moe.route, moe.dispatch, api.prefill

    def routed(*args, **kw):
        out = route(*args, **kw)
        seen["ids"].append(torch.sort(out[3], dim=-1).values.numpy())
        return out

    def dispatched(*args, **kw):
        out = dispatch(*args, **kw)
        seen["drops"].append(int((~out[3]).sum()))
        return out

    def prefilled(cfg, params, batch, cache, **kw):
        seen["rows"] += [t.shape[1] for _, t in base.tree_items(cache)]
        return prefill(cfg, params, batch, cache, **kw)

    with mock.patch.object(moe, "route", routed), mock.patch.object(moe, "dispatch", dispatched), \
            mock.patch.object(api, "prefill", prefilled):
        yield seen


def generate(cfg, params, prompts, extras, case) -> tuple:
    engine = Engine(cfg, params, ServeConfig(max_len=case["max_len"], max_new_tokens=case["new"],
                                             eos_id=case["eos"]), device="cpu")
    with recorded() as seen:
        tokens = engine.generate(prompts, extras)
    return tokens, seen


def run(d: Path, world: int) -> dict:
    out = {}
    mesh = make_host_mesh(data=DATA, model=world // DATA, device="cpu")
    out["data"], out["model"] = (np.int64(mesh.coordinate(a)) for a in ("data", "model"))
    for case in json.loads((d / "cases.json").read_text()):
        name, cfg = case["name"], case_config(case)
        z = np.load(d / f"{case['weights']}.npz")
        params = convert.from_jax_params(_tree(z, "w/"), device="cpu")
        extras = {k[2:]: z[k] for k in z.files if k.startswith("x/")}
        prompts = z["prompts"][:case["batch"]]
        extras = {k: v[:case["batch"]] for k, v in extras.items()}
        for side in ("plain", "split"):
            with shd.use_mesh(mesh, tensor.serving_rules(mesh)) if side == "split" \
                    else contextlib.nullcontext():
                tokens, seen = generate(cfg, params, prompts, extras, case)
                if side == "split":
                    out[f"{name}/fallbacks"] = np.array(json.dumps(
                        [list(f) for f in shd.fallbacks()]))
            out[f"{name}/{side}/tokens"] = tokens
            out[f"{name}/{side}/rows"] = np.array(seen["rows"])
            out[f"{name}/{side}/drops"] = np.array(seen["drops"], dtype=np.int64)
            out.update({f"{name}/{side}/ids{i}": a for i, a in enumerate(seen["ids"])})
    return out


def main(argv) -> int:
    rank, world, d = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    store = dist.FileStore(str(d / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = run(d, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
