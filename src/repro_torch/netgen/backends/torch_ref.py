"""torch backend: the dense masked-column-sum oracle over an ExecutionPlan.

Counterpart of `repro/netgen/backends/jnp.py`. Every layer is the
masked column-sum identity

    x @ W  ==  sum of W rows where x == 1      (x in {0,1})

realized as `where` + `sum` — adds only, no multiplies. Works for any
depth, always executes the dense plan form, and is what the `cuda`
target is checked against. Registered as the `torch` target with
`compile_torch_multi` as its multi-net form; see
`repro_torch.netgen.targets`.

Predictors take uint8 images (numpy or tensor) and return int32 class
ids as a tensor on the compile device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.netgen.graph import Circuit
from repro_torch.netgen.plan import ExecutionPlan, lower_circuit

__all__ = ["as_device_images", "compile_torch", "compile_torch_multi"]


def as_device_images(x_uint8, device: torch.device) -> torch.Tensor:
    """A uint8 image batch (numpy array or tensor) as a tensor on
    `device`."""
    if isinstance(x_uint8, torch.Tensor):
        return x_uint8.to(device)
    return torch.from_numpy(np.ascontiguousarray(x_uint8)).to(device)


def _column_sum(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * w[..., k, :] as a masked add over rows of w."""
    return torch.where(a[..., None], w, 0).sum(-2, dtype=torch.int32)


def compile_torch(circuit: Circuit, *, device: torch.device):
    """fn: uint8 images (B, n_in) -> int32 predictions (B,)."""
    return _execute_plan(lower_circuit(circuit), device)


def _execute_plan(plan: ExecutionPlan, device: torch.device):
    """The dense-plan executor: one masked column-sum per layer."""
    ws = [torch.as_tensor(l.weights, dtype=torch.int32, device=device)
          for l in plan.layers]
    thr = plan.input_threshold

    def predict(x_uint8):
        a = as_device_images(x_uint8, device).to(torch.int32) > thr
        for w in ws[:-1]:
            a = _column_sum(a, w) > 0
        return torch.argmax(_column_sum(a, ws[-1]), dim=-1).to(torch.int32)

    return predict


def compile_torch_multi(plan: ExecutionPlan, *, device: torch.device):
    """Multi-net dispatch over a *stacked* ExecutionPlan
    (`repro_torch.netgen.plan.stack_plans`): uint8 images (M, B, n_in)
    -> int32 predictions (M, B), the same arithmetic batched over the
    model axis."""
    if not plan.stacked:
        raise ValueError("compile_torch_multi needs a stacked ExecutionPlan")
    ws = [torch.as_tensor(l.weights, dtype=torch.int32, device=device)[:, None]
          for l in plan.layers]                        # (M, 1, K, N)
    thr = plan.input_threshold

    def predict(x_uint8):
        a = as_device_images(x_uint8, device).to(torch.int32) > thr
        for w in ws[:-1]:
            a = _column_sum(a, w) > 0
        return torch.argmax(_column_sum(a, ws[-1]), dim=-1).to(torch.int32)

    return predict
