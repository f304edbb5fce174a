"""One rank of the gloo worlds that tests/test_torch_tp_w8.py starts.

    python tests/_tp_w8_child.py <rank> <world> <dir>

Imports torch, numpy and `repro_torch` only: the parent quantizes the
weights with the reference's `quantize_params_for_serving` and hands the
W8 tree over as <dir>/<case>.npz (its `q` and `s` under their paths),
the cases as <dir>/cases.json. The process group comes from a
`FileStore` in <dir>. For each case the rank serves the prompts in fp32
on the CPU: unmeshed (the port's single-process W8 path), then split
over a (1, world) mesh under the serving rules, the whole W8 tree handed
to `Engine`, which cuts it: prefill and greedy decode steps on the
engine's shards, keeping the logits and tokens after each, and
`Engine.generate`. It writes the shards and those results to
<dir>/rank<rank>.npz.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from _tp_child import _tree, case_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, base, convert
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.serve.engine import Engine, ServeConfig


def steps(cfg, params, prompts, max_len: int, n: int) -> dict:
    """Prefill, then `n` greedy decode steps: the logits and tokens after
    each (on `params`, whole or this rank's shards)."""
    B, P = prompts.shape
    cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(
        cfg, B, tensor.cache_len(cfg, max_len))), torch.Generator().manual_seed(0), "cpu")
    out = {}
    with torch.inference_mode():
        logits, cache = api.prefill(cfg, params, {"tokens": torch.from_numpy(prompts).long()},
                                    cache)
        pos = torch.full((B,), P, dtype=torch.int32)
        for i in range(n + 1):
            tok = torch.argmax(logits, dim=-1)
            out[f"logits{i}"], out[f"tokens{i}"] = logits.numpy(), tok.numpy()
            if i < n:
                logits, cache = api.decode_step(cfg, params, tok[:, None], pos, cache)
                pos = pos + 1
    return out


def run(d: Path, world: int) -> dict:
    out = {}
    mesh = make_host_mesh(model=world, device="cpu")
    for case in json.loads((d / "cases.json").read_text()):
        name, cfg = case["name"], case_config(case)
        z = np.load(d / f"{name}.npz")
        params = convert.from_jax_params(_tree(z, "w/"), device="cpu")
        prompts = z["prompts"]
        plain = steps(cfg, params, prompts, case["max_len"], case["steps"])
        out.update({f"{name}/plain/{k}": v for k, v in plain.items()})
        with shd.use_mesh(mesh, tensor.serving_rules(mesh)):
            engine = Engine(cfg, params, ServeConfig(max_len=case["max_len"],
                                                     max_new_tokens=case["steps"] + 1),
                            device="cpu")
            split = steps(cfg, engine.params, prompts, case["max_len"], case["steps"])
            out[f"{name}/generate"] = engine.generate(prompts)
        out.update({f"{name}/split/{k}": v for k, v in split.items()})
        out.update({f"{name}/shard/{base.keystr(p)}": t.numpy()
                    for p, t in base.tree_items(engine.params)})
        out[f"{name}/coordinate"] = np.int64(mesh.coordinate("model"))
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
