"""Train-step factory: gradient accumulation over microbatches, remat, and
AdamW.

Counterpart of `repro/train/step.py` on one card. The global batch is
split into `accum` microbatches, in order; each microbatch's gradients
come from `torch.autograd.grad` of `api.loss_fn` and are accumulated leaf
by leaf in fp32 as `gsum + g / accum`, as the reference's scan does, so
the sums round in its order. Inside a microbatch, `remat="full"`
recomputes each layer in the backward pass, so only one microbatch's
logits and one layer's activations are alive at a time.

The gradients are taken through views of the parameters
(`detach().requires_grad_()`): no copy of the weights is made. The step
then updates the state in place (`adamw.apply_updates`), the
counterpart of the reference's donated buffers, and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.base import ArchConfig, ShapeConfig, tree_items, tree_map, tree_unflatten
from repro_torch.optim import adamw

__all__ = ["make_grad_fn", "make_train_step", "abstract_state"]


def make_grad_fn(cfg: ArchConfig, shape: ShapeConfig, *, remat: str = "full"):
    """Returns grad_fn(params, batch) -> (loss, metrics, grads): the mean
    loss over the `shape.accum` microbatches and the fp32 gradients
    accumulated as the reference's train step accumulates them. With one
    microbatch, `metrics` are `loss_fn`'s; with more, they are empty, as
    in the reference."""
    accum = max(shape.accum, 1)

    def grad_fn(params, batch):
        B = batch["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum {accum}")
        paths = [p for p, _ in tree_items(params)]
        loss_sum, gsum, metrics = None, None, {}
        for i in range(accum):
            mb = {k: v.reshape((accum, B // accum) + v.shape[1:])[i] for k, v in batch.items()}
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for _, t in tree_items(params)]
                loss, metrics = api.loss_fn(cfg, tree_unflatten(paths, leaves), mb, remat=remat)
                grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            if accum == 1:
                return loss, tree_map(torch.Tensor.detach, metrics), tree_unflatten(
                    paths, [g.float() for g in grads])
            if gsum is None:
                gsum = [g.float() / accum for g in grads]
                loss_sum = loss / accum
            else:
                for a, g in zip(gsum, grads):
                    a.add_(g.float() / accum)
                loss_sum = loss_sum + loss / accum
            del grads
        return loss_sum, {}, tree_unflatten(paths, gsum)

    return grad_fn


def make_train_step(cfg: ArchConfig, shape: ShapeConfig, oc: adamw.OptConfig,
                    *, remat: str = "full"):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt": {m, v, step}}, updated in place; batch per
    data.pipeline, as tensors on the state's device. The metrics are
    `loss_fn`'s (one microbatch only), `grad_norm`, `lr` and `loss`."""
    grad_fn = make_grad_fn(cfg, shape, remat=remat)

    def train_step(state, batch):
        loss, metrics, grads = grad_fn(state["params"], batch)
        _, _, opt_metrics = adamw.apply_updates(state["params"], grads, state["opt"], oc)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def abstract_state(cfg: ArchConfig) -> dict:
    """Abstract train state (ParamInfo trees): parameters and AdamW state."""
    ap = api.abstract_params(cfg)
    return {"params": ap, "opt": adamw.abstract_opt_state(ap)}
