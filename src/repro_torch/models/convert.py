"""Weights carried into the port from numpy.

The port draws its random weights from a `torch.Generator`, which gives
other bits than the reference's `jax.random` for the same seed. To hold
both packages to the same computation, a caller turns the reference's
parameter tree into numpy arrays (leaf by leaf, nested dicts kept) and
hands it to `from_jax_params`, which returns the port's tree of tensors
with the same keys, shapes and dtypes, `{"q", "s"}` leaves included.
A bfloat16 leaf (`ml_dtypes.bfloat16`, the dtype of the reference's
bf16 serving copy, which numpy cannot hand to torch) crosses bit for
bit as its uint16 words. The port itself never sees JAX, nor
`ml_dtypes`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["from_jax_params"]


def from_jax_params(tree, device=None) -> dict:
    """A tree of numpy arrays (nested dicts) -> the same tree of tensors
    on `device` (`cuda:0` when None, `_device.resolve_device`)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        a = np.array(node, copy=True, order="C")
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return conv(tree)
