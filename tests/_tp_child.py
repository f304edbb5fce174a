"""One rank of the gloo worlds that tests/test_torch_tp.py starts.

    python tests/_tp_child.py <rank> <world> <dir>

Imports torch, numpy and `repro_torch` only: the parent runs the JAX
reference and hands the weights, prompts and modality inputs over as
<dir>/<case>.npz, the cases as <dir>/cases.json. The process group comes
from a `FileStore` in <dir>. For each case the rank serves the prompts
twice from the same weights, in fp32 on the CPU: unmeshed (the port's
single-process path), and split over a (1, world) mesh under the serving
rules (`parallel/tensor.py`), prefill and then greedy decode steps,
keeping the logits, tokens and cache after each; then `Engine.generate`
under the mesh. It writes its parameter shards, those results and the
fallbacks to <dir>/tp_<rank>.npz.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, base, convert
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.serve.engine import Engine, ServeConfig


def case_config(case: dict):
    return dataclasses.replace(configs.smoke(case["arch"]), compute_dtype="float32",
                               **case["over"])


def _tree(z, prefix: str) -> dict:
    """The nested tree of the arrays saved under `prefix` + keystr."""
    items = [(k[len(prefix):], z[k]) for k in z.files if k.startswith(prefix)]
    paths = [tuple(part.strip("'") for part in k[1:-1].split("][")) for k, _ in items]
    return base.tree_unflatten(paths, [v for _, v in items])


def _serve(cfg, params, prompts, extras: dict, max_len: int, steps: int) -> dict:
    """Prefill, then `steps` greedy decode steps; logits, tokens and the
    cache after each."""
    B, P = prompts.shape
    cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(
        cfg, B, tensor.cache_len(cfg, max_len))), torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(prompts).long(),
             **{k: torch.from_numpy(v) for k, v in extras.items()}}
    out = {}
    with torch.inference_mode():
        logits, cache = api.prefill(cfg, params, batch, cache)
        pos = torch.full((B,), P, dtype=torch.int32)
        for i in range(steps + 1):
            tok = torch.argmax(logits, dim=-1)
            out[f"logits{i}"] = logits.numpy()
            out[f"tokens{i}"] = tok.numpy()
            out[f"k{i}"], out[f"v{i}"] = cache["k"].numpy(), cache["v"].numpy()
            if i == steps:
                break
            logits, cache = api.decode_step(cfg, params, tok[:, None], pos, cache)
            pos = pos + 1
    return out


def run(d: Path, world: int) -> dict:
    out = {}
    for case in json.loads((d / "cases.json").read_text()):
        name, cfg = case["name"], case_config(case)
        z = np.load(d / f"{name}.npz")
        params = convert.from_jax_params(_tree(z, "w/"), device="cpu")
        extras = {k[2:]: z[k] for k in z.files if k.startswith("x/")}
        prompts = z["prompts"]
        plain = _serve(cfg, params, prompts, extras, case["max_len"], case["steps"])
        out.update({f"{name}/plain/{k}": v for k, v in plain.items()})
        mesh = make_host_mesh(model=world, device="cpu")
        with shd.use_mesh(mesh, tensor.serving_rules()):
            shards = tensor.shard_params(cfg, params)
            fallbacks = shd.fallbacks()
            split = _serve(cfg, shards, prompts, extras, case["max_len"], case["steps"])
            engine = Engine(cfg, params, ServeConfig(max_len=case["max_len"],
                                                     max_new_tokens=case["steps"] + 1),
                            device="cpu")
            generated = engine.generate(prompts, extras)
        out.update({f"{name}/split/{k}": v for k, v in split.items()})
        out.update({f"{name}/shard/{base.keystr(p)}": t.numpy()
                    for p, t in base.tree_items(shards)})
        out[f"{name}/fallbacks"] = np.array(json.dumps([list(f) for f in fallbacks]))
        out[f"{name}/generate"] = generated
        out[f"{name}/coordinate"] = np.int64(mesh.coordinate("model"))
    return out


def main(argv) -> int:
    rank, world, d = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    store = dist.FileStore(str(d / "tp.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = run(d, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"tp_{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
