"""Device meshes of the port.

Counterpart of `repro/launch/mesh.py`. A `Mesh` wraps a
`torch.distributed.device_mesh.DeviceMesh` so that `.shape` is the
reference's `{axis: size}` mapping (what `parallel.sharding.spec`
reads), and each axis's process group and this rank's place along it
can be reached. The meshes are built by functions, never at import, so
importing this module touches no process group.

`make_mesh_compat` opens a one-rank process group itself when none
exists and the world is one process (no `WORLD_SIZE` above 1): over an
in-memory `HashStore`, with NCCL on the card, or gloo when the caller
passes `device="cpu"`. A world of several processes must open its group
before (`torch.distributed.init_process_group`, as the tests do from a
`FileStore`). The mesh takes the first `prod(shape)` ranks of the world.

Under a counting world, a process group of the `fake` backend opened by
`launch/dryrun.py` (`open_fake_world`: 256 or 512 ranks in one process,
whose collectives move nothing), a mesh of any device is built over it,
`meta` included: the dry run's steps run on storage-free tensors and
count rank 0's view.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh_compat", "make_production_mesh", "make_host_mesh", "HW",
           "FAKE_BACKEND"]

FAKE_BACKEND = "fake"       # launch/dryrun.py's counting world


class Mesh:
    """A named `DeviceMesh`: `.shape` {axis: size} in the mesh's order,
    `.group(axes)` the process group over one or more axes, `.coordinate(axis)` this
    rank's index along it, `.device_type` "cuda" or "cpu"."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.device_type = device_mesh.device_type
        self.shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.mesh.shape))
        self._groups: dict = {}

    def group(self, axes):
        """The process group over one axis, or over a tuple of axes (made
        once, by every rank in the same order, on first use)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            self._groups[axes] = self.device_mesh[axes]._flatten().get_group()
        return self._groups[axes]

    def coordinate(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def size(self, axes) -> int:
        """The number of ranks along `axes` (those the mesh has)."""
        return math.prod(self.shape[a] for a in axes if a in self.shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh_compat(shape, axes, *, device=None) -> Mesh:
    """A mesh of `shape` named `axes` over the first prod(shape) ranks, on
    the card (NCCL) unless `device="cpu"` (gloo)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    device_type = "cuda" if device is None else torch.device(device).type
    fake = dist.is_initialized() and str(dist.get_backend()) == FAKE_BACKEND
    if device_type not in ("cuda", "cpu") and not (fake and device_type == "meta"):
        raise ValueError(f"unsupported device {device} (want cuda or cpu; meta in a "
                         "counting world)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh runs on the GPU unless the caller "
                           "passes device='cpu'")
    backend = "nccl" if device_type == "cuda" else "gloo"
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError("WORLD_SIZE > 1 but no process group: call "
                               "torch.distributed.init_process_group first")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif not fake and backend not in str(dist.get_backend()):
        raise RuntimeError(f"a {device_type} mesh needs the {backend} backend; the "
                           f"process group has {dist.get_backend()}")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; this world has {world}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import DeviceMesh
    mesh = Mesh(DeviceMesh("cpu" if device_type == "meta" else device_type,
                           torch.arange(n).reshape(shape), mesh_dim_names=axes))
    mesh.device_type = device_type
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2 pods x 256 = 512 ranks (pod, data, model).
    Raises, naming the world size it found, unless the world has exactly
    that many ranks: it never builds a smaller mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} needs "
                           f"{math.prod(shape)} ranks; this world has {world}")
    return make_mesh_compat(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """Small mesh over whatever ranks exist (tests / examples)."""
    n = _world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return make_mesh_compat((data, model), ("data", "model"), device=device)


# The card's data-sheet peaks (NVIDIA H100 SXM5, dense, at its 700 W
# limit): the figures PERF.md's bounds use.
HW = {
    "device": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_bf16_flops": 989e12,     # FLOP/s, dense
    "hbm_bw": 3.35e12,             # B/s
    "nvlink_bw": 450e9,            # B/s a direction
}
