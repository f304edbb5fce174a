"""One rank of the gloo worlds that tests/test_torch_tp_ssm.py starts.

    python tests/_tp_ssm_child.py <rank> <world> <dir>

Imports torch, numpy and `repro_torch` only (and `_tp_child`'s helpers,
which do too): the parent runs the JAX reference and hands the weights
and prompts over as <dir>/<case>.npz, the cases as <dir>/cases.json.
The process group comes from a `FileStore` in <dir>. For each case (an
ssm or hybrid config) the rank serves the prompts in fp32 on the CPU:
unmeshed (the port's single-process path), then split over a (1, world)
mesh under the serving rules on both SSD routes (`use_kernel` True: the
`ssd_scan` op, whose plain version runs on CPU tensors; False: the
chunked plain route), prefill and then greedy decode steps, keeping the
logits, tokens and the whole cache after each; then `Engine.generate`
under the mesh. It gathers every shard back (`tensor.gather_leaf`) and
names the leaves that do not come back bitwise. With autograd on, it
runs layer 0's mixer on a seeded input, whole and split, and keeps the
output and the gradients of a seeded cotangent: the input's and each
mixer leaf's. It writes its shards, those results and the fallbacks to
<dir>/tp_<rank>.npz.
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
from repro_torch.layers import mamba2 as m2
from repro_torch.models import api, base, convert
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.serve.engine import Engine, ServeConfig

ROUTES = {"kernel": True, "chunked": False}


def _serve(cfg, params, prompts, max_len: int, steps: int, use_kernel: bool) -> dict:
    """Prefill, then `steps` greedy decode steps; logits, tokens and every
    cache leaf after each."""
    B, P = prompts.shape
    cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(
        cfg, B, tensor.cache_len(cfg, max_len))), torch.Generator().manual_seed(0), "cpu")
    out = {}
    with torch.inference_mode():
        logits, cache = api.prefill(cfg, params, {"tokens": torch.from_numpy(prompts).long()},
                                    cache, use_kernel=use_kernel)
        pos = torch.full((B,), P, dtype=torch.int32)
        for i in range(steps + 1):
            tok = torch.argmax(logits, dim=-1)
            out[f"logits{i}"] = logits.numpy()
            out[f"tokens{i}"] = tok.numpy()
            out.update({f"cache{i}/{base.keystr(p)}": t.numpy()
                        for p, t in base.tree_items(cache)})
            if i == steps:
                break
            logits, cache = api.decode_step(cfg, params, tok[:, None], pos, cache)
            pos = pos + 1
    return out


def _mixer_grads(cfg, params, group) -> dict:
    """Layer 0's mixer on a seeded (2, 8, D) input with autograd: the
    output, and the gradients of <output, seeded cotangent> with respect
    to the input and to each mixer leaf (this rank's shards when split)."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(2, 8, cfg.d_model)), dtype=torch.float32,
                     requires_grad=True)
    ct = torch.tensor(rng.normal(size=(2, 8, cfg.d_model)), dtype=torch.float32)
    lp = {k: v.detach().clone().requires_grad_()
          for k, v in base.layer(params["layers"], 0)["mixer"].items()}
    out = m2.mamba_mixer(cfg, lp, x, group=group)
    (out * ct).sum().backward()
    return {"out": out.detach().numpy(), "x": x.grad.numpy(),
            **{k: v.grad.numpy() for k, v in lp.items()}}


def run(d: Path, world: int) -> dict:
    out = {}
    for case in json.loads((d / "cases.json").read_text()):
        name, cfg = case["name"], case_config(case)
        z = np.load(d / f"{name}.npz")
        params = convert.from_jax_params(_tree(z, "w/"), device="cpu")
        prompts = z["prompts"]
        plain = _serve(cfg, params, prompts, case["max_len"], case["steps"], True)
        out.update({f"{name}/plain/{k}": v for k, v in plain.items()})
        out.update({f"{name}/grad/plain/{k}": v
                    for k, v in _mixer_grads(cfg, params, None).items()})
        mesh = make_host_mesh(model=world, device="cpu")
        with shd.use_mesh(mesh, tensor.serving_rules()):
            shards = tensor.shard_params(cfg, params)
            fallbacks = shd.fallbacks()
            for route, use_kernel in ROUTES.items():
                split = _serve(cfg, shards, prompts, case["max_len"], case["steps"], use_kernel)
                out.update({f"{name}/{route}/{k}": v for k, v in split.items()})
            out.update({f"{name}/grad/split/{k}": v for k, v in
                        _mixer_grads(cfg, shards, tensor.group_for(cfg)).items()})
            engine = Engine(cfg, params, ServeConfig(max_len=case["max_len"],
                                                     max_new_tokens=case["steps"] + 1),
                            device="cpu")
            generated = engine.generate(prompts)
            infos = dict(base.tree_items(api.abstract_params(cfg)))
            whole = dict(base.tree_items(params))
            differ = [base.keystr(p) for p, t in base.tree_items(shards)
                      if not torch.equal(tensor.gather_leaf(infos[p], t), whole[p])]
        out.update({f"{name}/shard/{base.keystr(p)}": t.numpy()
                    for p, t in base.tree_items(shards)})
        out[f"{name}/fallbacks"] = np.array(json.dumps([list(f) for f in fallbacks]))
        out[f"{name}/gather_differs"] = np.array(json.dumps(differ))
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
