"""One rank of the gloo worlds that tests/test_torch_init.py starts.

    python tests/_draw_child.py <rank> <world> <dir>

Imports torch, numpy and `repro_torch` only. The process group comes
from a `FileStore` in <dir>; a world of 2 is a (1, 2) (data, model)
mesh, a world of 4 a (2, 2) one, under the serving rules. For each case
(a smoke config, fp32 or W8) the rank draws the launcher's weights twice
(`launch.serve.draw_params`): once with no mesh, the whole tree, which
`tensor.shard_params` then cuts under the mesh, and once under the mesh,
where the draw keeps the rank's shards of each slice itself. It writes
both shard trees, the largest storage any op made during the meshed draw
(`Allocations`) beside the largest fp32 layer slice or unstacked leaf and
the largest shard, whether an op made a tensor of the whole shape of a
stacked leaf that the mesh cuts (where no part or shard has that
shape), and, for the W8 MoE tree, the error its prefill raises, to
<dir>/rank<rank>.npz.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, base
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor

CASES = [(arch, w8) for arch in ("qwen1.5-4b", "mamba2-2.7b", "zamba2-2.7b",
                                 "granite-moe-1b-a400m") for w8 in (False, True)]


class Allocations(TorchDispatchMode):
    """Every tensor an op returns: the largest storage in bytes (all
    dtypes, and fp32 alone) and the (shape, dtype) of each tensor that
    owns its storage."""

    def __init__(self):
        super().__init__()
        self.largest = self.largest_fp32 = 0
        self.shapes: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                n = t.untyped_storage().nbytes()
                self.largest = max(self.largest, n)
                if t.dtype == torch.float32:
                    self.largest_fp32 = max(self.largest_fp32, n)
                if n == t.numel() * t.element_size():
                    self.shapes.add((tuple(t.shape), t.dtype))
        return out


def part_shapes(tree) -> set:
    """The shapes of the parts a draw of `tree` makes: each layer slice of
    a stacked leaf, each unstacked leaf."""
    return {i.shape[1:] if p[0] == base.STACKED else i.shape for p, i in base.tree_items(tree)}


def part_bytes(tree) -> int:
    """The largest fp32 part a draw of `tree` makes."""
    return max(4 * math.prod(s) for s in part_shapes(tree))


def run(world: int) -> dict:
    data = 1 if world == 2 else 2
    mesh = make_host_mesh(data=data, model=world // data, device="cpu")
    out = {"coordinate": np.array([mesh.coordinate("data"), mesh.coordinate("model")])}
    for arch, w8 in CASES:
        name = f"{arch}/{'w8' if w8 else 'fp32'}"
        cfg = configs.smoke(arch)
        whole = serve.draw_params(cfg, "cpu", w8)
        abstract = api.abstract_params(cfg)
        with shd.use_mesh(mesh, tensor.serving_rules(mesh)):
            want = tensor.shard_params(cfg, whole)
            with Allocations() as seen:
                got = serve.draw_params(cfg, "cpu", w8)
            # a cut stacked leaf's whole shape, where no part or shard has it
            cut = ({i.shape for p, i in base.tree_items(abstract)
                    if p[0] == base.STACKED and tensor.local_info(i).shape != i.shape}
                   - part_shapes(abstract) - {tuple(t.shape) for _, t in base.tree_items(got)})
            if w8 and cfg.family == "moe":
                cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(cfg, 1, 8)),
                                       torch.Generator(), "cpu")
                try:
                    api.prefill(cfg, got, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                                cache)
                except TypeError as e:
                    out[f"{name}/refused"] = np.array(str(e))
        out.update({f"{name}/got/{base.keystr(p)}": t.numpy() for p, t in base.tree_items(got)})
        out.update({f"{name}/want/{base.keystr(p)}": t.numpy()
                    for p, t in base.tree_items(want)})
        shards = max(t.untyped_storage().nbytes() for _, t in base.tree_items(got))
        out[f"{name}/bytes"] = np.array([seen.largest, seen.largest_fp32, part_bytes(abstract),
                                         shards])
        out[f"{name}/cut_shapes"] = np.array(len(cut))
        out[f"{name}/whole_cut_leaf_made"] = np.array(any(s in cut for s, _ in seen.shapes))
    return out


def main(argv) -> int:
    rank, world, d = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    store = dist.FileStore(str(d / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = run(world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
