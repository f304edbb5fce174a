"""One rank of the gloo worlds that tests/test_torch_sp.py starts.

    python tests/_sp_child.py <rank> <world> <dir>

Imports torch, numpy and `repro_torch` only: the parent runs the JAX
reference and hands the weights, prompts and modality inputs over as
<dir>/<case>.npz, the cases as <dir>/cases.json. The process group comes
from a `FileStore` in <dir>. For each case the rank serves the prompts
in fp32 on the CPU: unmeshed (rank 0 only), and split over a (1, world)
mesh under the serving rules with the case's runtime flags (the hidden
state split along the sequence between layers where the prompt divides
the axis), prefill and then greedy decode steps, keeping the logits and
tokens after each, the sequence length of every attention and mixer
input of the prefill, the fallbacks recorded by the cut and the
serving, and `api.forward`'s logits of every position. A case with
`"whole": true` is served split a second time with the rules' "seq"
cleared (no sequence split), and both runs' logits are kept. Then
`gather_seq` and `scatter_seq` on small tensors against one process
(`unit/`). Everything goes to <dir>/sp_<rank>.npz.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import attention, mamba2
from repro_torch.models import api, base, convert, runtime
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor


def case_config(case: dict):
    return dataclasses.replace(configs.smoke(case["arch"]), compute_dtype="float32",
                               **case["over"])


def _tree(z, prefix: str) -> dict:
    items = [(k[len(prefix):], z[k]) for k in z.files if k.startswith(prefix)]
    paths = [tuple(part.strip("'") for part in k[1:-1].split("][")) for k, _ in items]
    return base.tree_unflatten(paths, [v for _, v in items])


@contextlib.contextmanager
def hidden_lengths():
    """Within: the sequence length of each attention and mixer input."""
    seen = []
    attn, mixer = attention.attention, mamba2.mamba_mixer

    def attended(cfg, p, x, *args, **kw):
        seen.append(x.shape[1])
        return attn(cfg, p, x, *args, **kw)

    def mixed(cfg, p, xin, **kw):
        seen.append(xin.shape[1])
        return mixer(cfg, p, xin, **kw)

    with mock.patch.object(attention, "attention", attended), \
            mock.patch.object(mamba2, "mamba_mixer", mixed):
        yield seen


def _serve(cfg, params, prompts, extras: dict, max_len: int, steps: int) -> dict:
    """Prefill, then `steps` greedy decode steps: logits and tokens after
    each, and the prefill's hidden lengths."""
    B, P = prompts.shape
    cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(
        cfg, B, tensor.cache_len(cfg, max_len))), torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(prompts).long(),
             **{k: torch.from_numpy(v) for k, v in extras.items()}}
    out = {}
    with torch.inference_mode():
        with hidden_lengths() as seen:
            logits, cache = api.prefill(cfg, params, batch, cache)
        out["hidden"] = np.array(seen, dtype=np.int64)
        pos = torch.full((B,), P, dtype=torch.int32)
        for i in range(steps + 1):
            tok = torch.argmax(logits, dim=-1)
            out[f"logits{i}"], out[f"tokens{i}"] = logits.numpy(), tok.numpy()
            if i == steps:
                break
            logits, cache = api.decode_step(cfg, params, tok[:, None], pos, cache)
            pos = pos + 1
    return out


def _forward(cfg, params, prompts, extras: dict) -> np.ndarray:
    batch = {"tokens": torch.from_numpy(prompts).long(),
             **{k: torch.from_numpy(v) for k, v in extras.items()}}
    with torch.inference_mode():
        return api.forward(cfg, params, batch)[0].numpy()


def run_case(case: dict, d: Path, world: int, lead: bool) -> dict:
    name, cfg = case["name"], case_config(case)
    z = np.load(d / f"{name}.npz")
    params = convert.from_jax_params(_tree(z, "w/"), device="cpu")
    extras = {k[2:]: z[k] for k in z.files if k.startswith("x/")}
    prompts = z["prompts"]
    out = {}
    with runtime.with_flags(**case.get("flags", {})):
        if lead:
            plain = _serve(cfg, params, prompts, extras, case["max_len"], case["steps"])
            out.update({f"{name}/plain/{k}": v for k, v in plain.items()})
            out[f"{name}/plain/forward"] = _forward(cfg, params, prompts, extras)
        mesh = make_host_mesh(model=world, device="cpu")
        with shd.use_mesh(mesh, tensor.serving_rules()):
            shards = tensor.shard_params(cfg, params)
            split = _serve(cfg, shards, prompts, extras, case["max_len"], case["steps"])
            out[f"{name}/fallbacks"] = np.array(json.dumps([list(f) for f in shd.fallbacks()]))
            split["forward"] = _forward(cfg, shards, prompts, extras)
        out.update({f"{name}/split/{k}": v for k, v in split.items()})
        if case.get("whole"):
            with shd.use_mesh(mesh, {**tensor.serving_rules(), "seq": ()}):
                whole = _serve(cfg, shards, prompts, extras, case["max_len"], case["steps"])
            out.update({f"{name}/whole/{k}": v for k, v in whole.items()})
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def units(world: int) -> dict:
    """gather_seq and scatter_seq on small fp32 tensors (the same on every
    rank, from one seed) against one process, as relative errors: each
    one's output and input gradient, every rank's loss summed."""
    group = tensor.model_group()
    r = dist.get_rank(group)
    gen = torch.Generator().manual_seed(11)
    n = 3
    X = torch.randn(2, n * world, 5, generator=gen)
    W = torch.randn(world, 2, n * world, 5, generator=gen)      # each rank's upstream weights
    Z = torch.randn(world, 2, n * world, 5, generator=gen)      # each rank's partial
    own = slice(r * n, (r + 1) * n)
    out = {}
    # gather_seq: the whole sequence from every rank's positions; x's
    # gradient the sum of every rank's, at its positions
    x = X[:, own].clone().requires_grad_(True)
    y = tensor.gather_seq(x, group)
    gx, = torch.autograd.grad((y * W[r]).sum(), x)
    out["gather_seq/out"] = _rel(y.detach(), X)
    out["gather_seq/grad"] = _rel(gx, W.sum(0)[:, own])
    # scatter_seq: this rank's positions of the sum of every rank's
    # partial; each partial's gradient the whole upstream gradient
    zr = Z[r].clone().requires_grad_(True)
    y = tensor.scatter_seq(zr, group)
    gz, = torch.autograd.grad((y * W[0][:, own]).sum(), zr)
    out["scatter_seq/out"] = _rel(y.detach(), Z.sum(0)[:, own])
    out["scatter_seq/grad"] = _rel(gz, W[0])
    return {f"unit/{k}": np.float64(v) for k, v in out.items()}


def main(argv) -> int:
    rank, world, d = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "sp.store"), world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for case in json.loads((d / "cases.json").read_text()):
            out.update(run_case(case, d, world, rank == 0))
        with shd.use_mesh(make_host_mesh(model=world, device="cpu"), tensor.serving_rules()):
            out.update(units(world))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"sp_{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
