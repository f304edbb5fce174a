"""One rank of the gloo worlds that tests/test_torch_mesh.py starts.

    python tests/_mesh_child.py <job> <rank> <world> <dir>

Imports torch, numpy and `repro_torch` only: the parent runs the JAX
reference and hands its inputs over as .npz/.json files in <dir>. The
process group comes from a `FileStore` in <dir>; each rank writes what
it computed to <dir>/<job>_<rank>.npz.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh, make_mesh_compat
from repro_torch.models import base, runtime
from repro_torch.parallel import sharding as shd

MOE_ARCH = "granite-moe-1b-a400m"
TRAIN_ARCHS = ("gemma-2b", "granite-moe-1b-a400m", "qwen2-vl-2b")


def _moe(d: Path) -> dict:
    """moe_shardmap on a 2x4 mesh: this rank's data shard of x; the
    gradients of out.sum() by x and by the router, beside the plain
    layer's on the same shard."""
    from repro_torch.layers import moe
    z = np.load(d / "moe_in.npz")
    cfg = configs.smoke(MOE_ARCH)
    p = {k: torch.from_numpy(z[k]) for k in ("router", "wi", "wg", "wo")}
    p["router"].requires_grad_(True)
    mesh = make_host_mesh(data=2, model=4, device="cpu")
    di = mesh.coordinate("data")
    rows = z["x"].shape[0] // 2
    x = torch.from_numpy(z["x"][di * rows:(di + 1) * rows]).requires_grad_(True)
    with shd.use_mesh(mesh, {"batch": ("data",)}), runtime.with_flags(moe_impl="shardmap"):
        out, aux = moe.moe(cfg, p, x, capacity_factor=4.0)
        grad, router_grad = torch.autograd.grad(out.sum(), (x, p["router"]))
    xp = x.detach().clone().requires_grad_(True)
    plain, _ = moe.moe(cfg, p, xp, capacity_factor=4.0)
    plain_grad, plain_router = torch.autograd.grad(plain.sum(), (xp, p["router"]))
    return {"out": out.detach().numpy(), "lb": aux["lb_loss"].detach().numpy(),
            "zl": aux["z_loss"].detach().numpy(), "grad": grad.numpy(),
            "plain_grad": plain_grad.numpy(), "router_grad": router_grad.numpy(),
            "plain_router_grad": plain_router.numpy(), "data": np.int64(di)}


def _counts(server) -> np.ndarray:
    c = server.dispatch_counts
    return np.array([c["single"], c["stacked"], c["sharded"], c["fallback"]])


def _dispatch(d: Path) -> dict:
    """The sharded stacked dispatch over 8 data ranks on the torch target."""
    from repro_torch import netgen
    from repro_torch.core import quantize
    z = np.load(d / "dispatch_in.npz")
    nets = {v: quantize.QuantizedNet(weights=[z[f"{v}0"], z[f"{v}1"]]) for v in "ab"}
    x = z["x"]

    def server():
        s = netgen.NetServer(session=netgen.Session(device="cpu"), target="torch",
                             slot_capacity=8, warmup=False)
        for v, net in nets.items():
            s.register(v, net)
        return s

    out, s = {}, server()
    req = {"a": x, "b": x}
    for label, mesh in (("plain", None), ("sharded", make_host_mesh(data=8, device="cpu")),
                        ("after", None)):
        with shd.use_mesh(mesh):
            got = s.predict_many(req)
        out.update({f"{label}_{v}": got[v] for v in "ab"})
        out[f"{label}_counts"] = _counts(s)
    s = server()
    with shd.use_mesh(make_mesh_compat((8,), ("model",), device="cpu")):
        got = s.predict_many(req)
    out.update({f"nodata_{v}": got[v] for v in "ab"})
    out["nodata_counts"] = _counts(s)
    for v, net in nets.items():
        out[f"want_{v}"] = quantize.predict_quantized(net, device="cpu")(x).numpy()
    return out


def _restore(d: Path) -> dict:
    """A saved train state restored under a 2x4 mesh: every leaf a DTensor
    whose local shard is the reference spec's slice of the saved array."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import ckpt
    from repro_torch.train import step
    specs = json.loads((d / "restore_specs.json").read_text())
    mesh = make_host_mesh(data=2, model=4, device="cpu")
    coord = {a: mesh.coordinate(a) for a in mesh.shape}
    with shd.use_mesh(mesh, {"batch": ("data",)}):
        state = ckpt.restore(str(d / "ckpt" / "step_00000007"),
                             step.abstract_state(configs.smoke(MOE_ARCH)), device="cpu")
    saved = np.load(d / "ckpt" / "step_00000007" / "arrays.npz")
    bad, split = [], 0
    for p, t in base.tree_items(state):
        key = base.keystr(p)
        want = saved[key]
        for dim, part in enumerate(specs[key]):
            names = [part] if isinstance(part, str) else list(part or [])
            if not names:
                continue
            idx, n = 0, math.prod(mesh.shape[a] for a in names)
            for a in names:
                idx = idx * mesh.shape[a] + coord[a]
            size = want.shape[dim] // n
            want = np.take(want, range(idx * size, (idx + 1) * size), axis=dim)
            split += 1
        if not isinstance(t, DTensor) or not np.array_equal(t.to_local().numpy(), want):
            bad.append(key)
    return {"bad": np.array(bad, dtype=str), "split_dims": np.int64(split)}


def _psum(d: Path, rank: int) -> dict:
    from repro_torch.optim import compression
    z = np.load(d / "psum_in.npz")
    with shd.use_mesh(make_host_mesh(data=4, device="cpu")):
        total, err = compression.compressed_psum(
            torch.from_numpy(z[f"x{rank}"]), "data", torch.from_numpy(z[f"e{rank}"]))
    return {"total": total.numpy(), "err": err.numpy()}


def train_setup(arch: str):
    """(cfg, shape, OptConfig, TrainerConfig kwargs) of the two-step runs."""
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(configs.smoke(arch), compute_dtype="float32")
    shape = base.ShapeConfig("s", 16, 4, "train", accum=2)
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    return cfg, shape, oc, {"total_steps": 2, "ckpt_every": 1000, "seed": 3, "data_seed": 5}


def flat(tree) -> dict:
    return {base.keystr(p): t.detach().numpy() for p, t in base.tree_items(tree)}


def initial_state(d: Path, arch: str):
    """The reference's initial train state of `arch`, which the parent
    saved as step 0 of <d>/ckpt_<arch>."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.train import step
    cfg, _, _, _ = train_setup(arch)
    return ckpt.restore(str(d / f"ckpt_{arch}" / "step_00000000"), step.abstract_state(cfg),
                        device="cpu")


def _grad_on_another_thread(*args, **kwargs):
    """`torch.autograd.grad` run on a new thread, as autograd runs a CUDA
    backward on its device thread: the thread-local mesh, flags and
    reduction group of the caller are not set there."""
    out = {}

    def run():
        try:
            out["grads"] = _GRAD(*args, **kwargs)
        except BaseException as e:      # re-raised on the caller's thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["grads"]


_GRAD = torch.autograd.grad


def _train(d: Path, rank: int) -> dict:
    """Two trainer steps on 2 data ranks for each of TRAIN_ARCHS, resumed
    from the reference's initial state; two steps of the vlm train step on
    a batch whose loss mask gives the ranks unequal token counts, and its
    gradients; granite-moe's remat="full" gradients with the backward
    (and so the recompute) on another thread; the launcher's --multi-pod
    error."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.train import step, trainer
    out = {}
    mesh = make_host_mesh(data=2, device="cpu")
    for arch in TRAIN_ARCHS:
        cfg, shape, oc, kw = train_setup(arch)
        tc = trainer.TrainerConfig(ckpt_dir=str(d / f"ckpt_{arch}"), **kw)
        with shd.use_mesh(mesh, {"batch": ("data",)}):
            state, hist = trainer.run(cfg, shape, oc, tc, resume=True, device="cpu")
            state = step.whole_state(cfg, state)     # the dense family's FSDP shards, gathered
        out[f"{arch}/loss"] = np.array(hist["loss"])
        out.update({f"{arch}/{k}": v for k, v in flat(state["params"]).items()})
    cfg, shape, oc, _ = train_setup("qwen2-vl-2b")
    z = np.load(d / "vlm_batches.npz")
    state = initial_state(d, "qwen2-vl-2b")
    train_step = step.make_train_step(cfg, shape, oc, remat="none")
    losses = []
    with shd.use_mesh(mesh, {"batch": ("data",)}):
        for i in range(2):
            batch = {k.split("/")[1]: torch.from_numpy(z[k]) for k in z.files
                     if k.startswith(f"{i}/")}
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))
    out["mask/loss"] = np.array(losses)
    out.update({f"mask/{k}": v for k, v in flat(state["params"]).items()})
    params = initial_state(d, "qwen2-vl-2b")["params"]
    batch = {k.split("/")[1]: torch.from_numpy(z[k]) for k in z.files if k.startswith("0/")}
    with shd.use_mesh(mesh, {"batch": ("data",)}):
        _, _, grads = step.make_grad_fn(cfg, shape, remat="none")(params, batch)
    out.update({f"grad/{k}": v for k, v in flat(grads).items()})
    cfg, shape, _, kw = train_setup(MOE_ARCH)
    params = initial_state(d, MOE_ARCH)["params"]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, 0,
                                                            seed=kw["data_seed"]).items()}
    torch.autograd.grad = _grad_on_another_thread
    try:
        with shd.use_mesh(mesh, {"batch": ("data",)}):
            loss, _, grads = step.make_grad_fn(cfg, shape, remat="full")(params, batch)
    finally:
        torch.autograd.grad = _GRAD
    out["remat/loss"] = loss.numpy()
    out.update({f"remat/{k}": v for k, v in flat(grads).items()})
    try:
        launch_train.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--multi-pod"])
        out["multi_pod"] = np.array("no error")
    except RuntimeError as e:
        out["multi_pod"] = np.array(str(e))
    return out


def main(argv) -> int:
    job, rank, world, d = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    torch.set_num_threads(1)
    store = dist.FileStore(str(d / f"{job}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        if job == "eight":
            out = {f"moe/{k}": v for k, v in _moe(d).items()}
            out.update({f"dispatch/{k}": v for k, v in _dispatch(d).items()})
            out.update({f"restore/{k}": v for k, v in _restore(d).items()})
        elif job == "psum":
            out = _psum(d, rank)
        elif job == "train":
            out = _train(d, rank)
        else:
            raise ValueError(job)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"{job}_{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
