"""One rank of the gloo worlds that tests/test_torch_tp_train.py and
tests/test_torch_tp_ssm_train.py start.

    python tests/_tp_train_child.py <rank> <data> <model> <dir>

Imports torch, numpy and `repro_torch` only: the parent draws each
case's weights and hands them over as <dir>/<case>.npz (`w/<keystr>`,
and `b<i>/<key>` for a case with its own batches) and as a whole train
state saved as step 0 of <dir>/ckpt_<case>, the cases as
<dir>/cases.json. The process group comes from a `FileStore` in <dir>; a
(data, model) mesh over it under the reference trainer's rules
(`tensor.training_rules`). For each case the rank

* on rank 0 only: runs the port's one-process train step twice from the
  whole state (`plain/`);
* resumes `trainer.run` from <dir>/ckpt_<case> under the mesh with
  remat="full" (or, for a case with its own batches, runs
  `make_train_step` on the state cut by `step.shard_state`), which
  checkpoints the whole state at step 2 through rank 0;
* keeps its initial and final shards (`init/`, `shard/`), the whole final
  parameters gathered from every rank's (`whole/`, rank 0), the losses
  and grad norms, the fallbacks of the parameter tree's cut,
  `global_norm` of the initial parameters' shards (each leaf's squares
  summed over the axes that cut it, a shared Mamba2 B or C column
  counted once) and of the whole tree,
  and the first batch's gradients from the initial shards, gathered,
  beside one process's (`grad/whole/`, `grad/plain/`, rank 0); that
  backward runs on another thread, as autograd runs a CUDA backward on
  its device thread, so each layer's recompute (its FSDP gathers and
  collectives) runs where the forward's mesh is not set.

A case's `flags` are the runtime flags (`models.runtime.with_flags`)
everything of it runs under. Then the autograd collectives against one
process on small tensors (`unit/`). It writes everything to
<dir>/tp_<rank>.npz.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from _mesh_child import _GRAD, _grad_on_another_thread
from repro_torch import configs
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import api, base, convert, runtime
from repro_torch.optim import adamw
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel import sharding as shd
from repro_torch.train import step, trainer


def case_setup(case: dict):
    """(cfg, shape, OptConfig) of a case."""
    cfg = dataclasses.replace(configs.smoke(case["arch"]), compute_dtype="float32",
                              **case["over"])
    shape = base.ShapeConfig("s", case["seq"], case["batch"], "train", accum=case["accum"])
    oc = adamw.OptConfig(lr=case["lr"], warmup_steps=2, total_steps=50)
    return cfg, shape, oc


def whole_state(cfg, z) -> dict:
    """The case's initial train state: the parameters of <case>.npz, AdamW's
    moments and step zero."""
    items = [(k[2:], z[k]) for k in z.files if k.startswith("w/")]
    paths = [tuple(part.strip("'") for part in k[1:-1].split("][")) for k, _ in items]
    params = convert.from_jax_params(base.tree_unflatten(paths, [v for _, v in items]),
                                     device="cpu")
    opt = base.tree_init(adamw.abstract_opt_state(api.abstract_params(cfg)),
                         torch.Generator(), "cpu")
    return {"params": params, "opt": opt}


def batches(cfg, shape, case: dict, z) -> list[dict]:
    if case.get("own_batches"):
        return [{k.split("/")[1]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith(f"b{i}/")} for i in range(2)]
    return [{k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, s,
                                                           seed=case["data_seed"]).items()}
            for s in range(2)]


def flat(tree, prefix: str) -> dict:
    return {f"{prefix}/{base.keystr(p)}": t.detach().numpy().copy()
            for p, t in base.tree_items(tree)}


def run_case(case: dict, d: Path, mesh, lead: bool) -> dict:
    name = case["name"]
    cfg, shape, oc = case_setup(case)
    z = np.load(d / f"{name}.npz")
    bs = batches(cfg, shape, case, z)
    out = {}
    if lead:
        state = whole_state(cfg, z)
        train_step = step.make_train_step(cfg, shape, oc, remat="none")
        losses, norms = [], []
        for b in bs:
            state, m = train_step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out.update(flat(state["params"], f"{name}/plain"))
        out[f"{name}/plain/loss"], out[f"{name}/plain/gnorm"] = np.array(losses), np.array(norms)
    with shd.use_mesh(mesh, tensor.training_rules(mesh)):
        tensor.local_tree(cfg, api.abstract_params(cfg), tensor.TRAIN_AXES)
        out[f"{name}/fallbacks"] = np.array(json.dumps([list(f) for f in shd.fallbacks()]))
        whole = whole_state(cfg, z)
        init = step.shard_state(cfg, whole)
        out.update(flat(init["params"], f"{name}/init"))
        torch.autograd.grad = _grad_on_another_thread
        try:
            _, _, grads = step.make_grad_fn(cfg, shape, remat="full")(init["params"], bs[0])
        finally:
            torch.autograd.grad = _GRAD
        grads = step.whole_state(cfg, {"params": grads})["params"]
        groups = step._norm_groups(cfg, init["params"])
        weights = step._norm_weights(cfg, init["params"])
        out[f"{name}/norm/shards"] = adamw.global_norm(init["params"], groups, weights).numpy()
        out[f"{name}/norm/whole"] = adamw.global_norm(whole["params"]).numpy()
        if case.get("own_batches"):
            train_step = step.make_train_step(cfg, shape, oc, remat="full")
            state, losses, norms = init, [], []
            for b in bs:
                state, m = train_step(state, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        else:
            tc = trainer.TrainerConfig(total_steps=2, ckpt_every=2,
                                       ckpt_dir=str(d / f"ckpt_{name}"), seed=0,
                                       data_seed=case["data_seed"], remat="full")
            state, hist = trainer.run(cfg, shape, oc, tc, resume=True, device="cpu")
            losses, norms = hist["loss"], hist["grad_norm"]
        out.update(flat(state["params"], f"{name}/shard"))
        gathered = step.whole_state(cfg, state)
    if lead:
        out.update(flat(gathered["params"], f"{name}/whole"))
        out.update(flat(grads, f"{name}/grad/whole"))
        _, _, plain = step.make_grad_fn(cfg, shape, remat="none")(whole_state(cfg, z)["params"],
                                                                  bs[0])
        out.update(flat(plain, f"{name}/grad/plain"))
    out[f"{name}/loss"], out[f"{name}/gnorm"] = np.array(losses), np.array(norms)
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def units(mesh) -> dict:
    """copy_to, reduce_from, gather_from, fsdp.gather and vocab_nll on
    small fp32 tensors (the same on every rank, from one seed) against
    one process: each collective's output and input gradient, as
    relative errors."""
    gen = torch.Generator().manual_seed(11)
    m, r = mesh.shape["model"], mesh.coordinate("model")
    n, q = mesh.shape["data"], mesh.coordinate("data")
    mg, dg = mesh.group("model"), mesh.group("data")
    X = torch.randn(4, 6, generator=gen)
    W = torch.randn(6, 8 * m, generator=gen)
    C = torch.randn(4, 8 * m, generator=gen)
    out = {}
    # copy_to before a column-split product: x's gradient summed over model
    x = X.clone().requires_grad_(True)
    w = W[:, r * 8:(r + 1) * 8]
    y = tensor.copy_to(x, mg) @ w
    gx, = torch.autograd.grad((y * C[:, r * 8:(r + 1) * 8]).sum(), x)
    xw = X.clone().requires_grad_(True)
    want, = torch.autograd.grad(((xw @ W) * C).sum(), xw)
    out["copy_to/grad"] = _rel(gx, want)
    # reduce_from after a row-split product: the output summed, the gradient local
    A = torch.randn(4, 3 * m, generator=gen)
    B = torch.randn(3 * m, 5, generator=gen)
    D = torch.randn(4, 5, generator=gen)
    a = A[:, r * 3:(r + 1) * 3].clone().requires_grad_(True)
    y = tensor.reduce_from(a @ B[r * 3:(r + 1) * 3], mg)
    ga, = torch.autograd.grad((y * D).sum(), a)
    aw = A.clone().requires_grad_(True)
    yw = aw @ B
    gw, = torch.autograd.grad((yw * D).sum(), aw)
    out["reduce_from/out"] = _rel(y.detach(), yw.detach())
    out["reduce_from/grad"] = _rel(ga, gw[:, r * 3:(r + 1) * 3])
    # gather_from: every rank's slice, the gradient of this rank's slice
    a = A[:, r * 3:(r + 1) * 3].clone().requires_grad_(True)
    y = tensor.gather_from(a, mg)
    ga, = torch.autograd.grad((y * C[:, :3 * m]).sum(), a)
    out["gather_from/out"] = _rel(y.detach(), A)
    out["gather_from/grad"] = _rel(ga, C[:, r * 3:(r + 1) * 3])
    # fsdp.gather over data along dim 1: the gradient summed over data, sliced
    P = torch.randn(5, 4 * n, generator=gen)
    E = torch.randn(n, 5, 4 * n, generator=gen)       # each data rank's upstream gradient
    s = P[:, q * 4:(q + 1) * 4].clone().requires_grad_(True)
    y = fsdp.gather(s, 1, dg)
    gs, = torch.autograd.grad((y * E[q]).sum(), s)
    out["fsdp.gather/out"] = _rel(y.detach(), P)
    out["fsdp.gather/grad"] = _rel(gs, E.sum(0)[:, q * 4:(q + 1) * 4])
    # vocab_nll over model on logits split by vocab, against logsumexp
    L = torch.randn(3, 7, 10 * m, generator=gen) * 3
    T = torch.randint(0, 10 * m, (3, 7), generator=gen)
    lf = L[..., r * 10:(r + 1) * 10].clone().requires_grad_(True)
    nll = tensor.vocab_nll(lf, T, mg)
    U = torch.randn(3, 7, generator=gen)
    gl, = torch.autograd.grad((nll * U).sum(), lf)
    lw = L.clone().requires_grad_(True)
    want = torch.logsumexp(lw, -1) - torch.take_along_dim(lw, T[..., None], -1)[..., 0]
    gw, = torch.autograd.grad((want * U).sum(), lw)
    out["vocab_nll/out"] = _rel(nll.detach(), want.detach())
    out["vocab_nll/grad"] = _rel(gl, gw[..., r * 10:(r + 1) * 10])
    return {f"unit/{k}": np.float64(v) for k, v in out.items()}


def main(argv) -> int:
    rank, data, model, d = int(argv[0]), int(argv[1]), int(argv[2]), Path(argv[3])
    torch.set_num_threads(1)
    world = data * model
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "tp.store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh_compat((data, model), ("data", "model"), device="cpu")
        out = {"coord/data": np.int64(mesh.coordinate("data")),
               "coord/model": np.int64(mesh.coordinate("model"))}
        for case in json.loads((d / "cases.json").read_text()):
            with runtime.with_flags(**case.get("flags", {})):
                out.update(run_case(case, d, mesh, rank == 0))
        out.update(units(mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"tp_{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
