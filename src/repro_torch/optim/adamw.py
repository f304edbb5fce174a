"""AdamW with fp32 moments, global gradient clipping and a warmup-cosine
schedule.

Counterpart of `repro/optim/adamw.py` on one card: the reference's
moments inherit the parameters' sharding; here they sit beside them.
fp32 master parameters and fp32 moments; the forward casts to the
compute dtype at use sites. The update is the reference's arithmetic in
its order of operations: the clip scale min(1, clip / (|g| + 1e-9)),
the bias corrections 1 - b^t, and the weight decay inside the delta,
p - lr (m_hat / (sqrt(v_hat) + eps) + wd p). `torch.optim.AdamW` applies
the decay as a separate multiply, which rounds differently, so it is
not used.

`apply_updates` works in place under `torch.no_grad()`, so a
full-width state is held once: it advances `opt_state["step"]`, updates
the moments and the parameters, and consumes the gradients (scaled by
the clip in place). It returns the reference's (params, opt_state,
metrics), the first two being the trees it was given.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.base import ParamInfo, tree_items, tree_map

__all__ = ["OptConfig", "abstract_opt_state", "schedule", "global_norm", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def abstract_opt_state(abstract_params) -> dict:
    """m and v mirror the parameter tree (same shapes and logical axes,
    fp32); step is an int32 scalar."""
    def zero_like(i: ParamInfo) -> ParamInfo:
        return ParamInfo(i.shape, torch.float32, i.logical, init="zeros")

    return {"m": tree_map(zero_like, abstract_params),
            "v": tree_map(zero_like, abstract_params),
            "step": ParamInfo((), torch.int32, (), init="zeros")}


def schedule(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at `step` (a tensor or an int), in fp32: linear
    warmup, then a cosine down to `min_lr_ratio` of `lr`."""
    s = torch.as_tensor(step).float()
    warm = s / max(oc.warmup_steps, 1)
    prog = torch.clamp((s - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos
    return oc.lr * torch.where(s < oc.warmup_steps, warm, decayed)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in flatten order) of each leaf's
    sum of squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for _, g in tree_items(tree)))


@torch.no_grad()
def apply_updates(params, grads, opt_state, oc: OptConfig):
    """One AdamW step, in place. Returns (params, opt_state, metrics):
    `grad_norm` (before the clip) and `lr`."""
    step = opt_state["step"].add_(1)
    s = step.float()
    lr = schedule(oc, step)

    gnorm = global_norm(grads)
    # a true division, as the reference's (a Python float over a tensor
    # would be a reciprocal times the float)
    scale = torch.clamp_max(gnorm.new_tensor(oc.clip_norm) / (gnorm + 1e-9), 1.0)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - torch.pow(s.new_tensor(b1), s)
    bc2 = 1 - torch.pow(s.new_tensor(b2), s)

    for (_, p), (_, g), (_, m), (_, v) in zip(tree_items(params), tree_items(grads),
                                              tree_items(opt_state["m"]),
                                              tree_items(opt_state["v"])):
        g = g.float().mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((g * (1 - b2)).mul_(g))
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(oc.eps)).add_(oc.weight_decay * p)
        p.sub_(delta.mul_(lr))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
