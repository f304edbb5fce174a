"""The paper's network: a 784-500-10 feed-forward classifier, in PyTorch.

Counterpart of `repro/core/mlp.py` (paper §II.A, sampled from Rashid,
*Make Your Own Neural Network*): 784 inputs (a 28x28 image as a
vector), 500 hidden units, 10 outputs, a sigmoid after every layer, no
biases, trained by plain backpropagation (SGD on the mean squared error
against 0.99/0.01 targets). Inputs are scaled into (0, 1] exactly as in
the book (0.01 + x/255 * 0.99).

Training runs on `device` (the card unless the caller passes "cpu")
through `torch.autograd` over `torch.matmul`; the reference trains
with `jax.grad` over `x @ w`, outside any Pallas kernel, so no kernel
of the port has a backward pass. Everything stays on the device for
the whole run; the trained parameters come back as numpy arrays, as
the reference returns them, so `quantize.quantize` and
`quantize.params_from_numpy` take them unchanged.

Batch order is the reference's exactly: `np.random.default_rng(seed)`
draws one permutation per epoch, batches of 10, the tail dropped. From
the same initial weights the port walks the same SGD trajectory as the
reference, up to fp32 summation order. The initial weights themselves
come from a `torch.Generator` seeded with `cfg.seed` on the CPU (then
moved to the device, so the CPU and the card start from the same
weights); they cannot equal `jax.random.normal`'s draw for that seed.

Precision: fp32 with TF32 off, for training and for the float
predictors (`predict_l0` here, `quantize.predict_l1`/`predict_l2`).
The L1 and L2 predictors step every hidden accumulator at exactly 0, so
a 10-bit-mantissa product (TF32) moves units across the step and with
them predictions; `full_fp32()` holds the matmul precision at "highest"
for the duration of each call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "MLPConfig", "accuracy", "forward", "full_fp32", "init_params",
    "layer_sizes", "predict_l0", "scale_inputs", "train",
]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    n_in: int = 784
    # One int reproduces the paper's single hidden layer; a tuple of ints
    # builds a deeper stack (e.g. (256, 64)) — the netgen compiler lowers
    # either through the same ladder.
    n_hidden: int | tuple = 500
    n_out: int = 10
    lr: float = 2.0
    # The paper trains 5 epochs on 1000 MNIST images for 98%. On the
    # synthetic stand-in dataset (see dataset.py) the same protocol needs
    # more epochs to converge, as in the reference.
    epochs: int = 60
    seed: int = 42


def layer_sizes(cfg: MLPConfig) -> tuple[int, ...]:
    hidden = (cfg.n_hidden,) if isinstance(cfg.n_hidden, int) else tuple(cfg.n_hidden)
    return (cfg.n_in, *hidden, cfg.n_out)


def _weight_keys(params: dict) -> list[str]:
    return sorted((k for k in params if re.fullmatch(r"w\d+", k)),
                  key=lambda k: int(k[1:]))


@contextlib.contextmanager
def full_fp32():
    """fp32 products in full fp32 (no TF32) inside the block; the
    process's previous matmul precision is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def init_params(cfg: MLPConfig, device=None) -> dict:
    """Rashid-style init: normal(0, 1/sqrt(fan_in)), no biases. One
    `torch.Generator` seeded with `cfg.seed` draws every layer in order
    on the CPU; the weights then move to `device`. Returns {"w1": ...,
    "wN": ...} as fp32 tensors."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    sizes = layer_sizes(cfg)
    return {
        f"w{i+1}": (torch.randn((m, n), generator=gen, dtype=torch.float32)
                    * (m ** -0.5)).to(dev)
        for i, (m, n) in enumerate(zip(sizes, sizes[1:]))
    }


def scale_inputs(x_uint8: torch.Tensor) -> torch.Tensor:
    """Book/paper input scaling: (0, 1] range, never exactly 0."""
    return x_uint8.to(torch.float32) / 255.0 * 0.99 + 0.01


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-precision forward pass (ladder stage L0), any depth. x: scaled
    floats; sigmoid after every layer, as in the book's network."""
    for k in _weight_keys(params):
        x = torch.sigmoid(x @ params[k])
    return x


def _targets(y: torch.Tensor, n_out: int) -> torch.Tensor:
    """Book-style targets: 0.99 for the true class, 0.01 elsewhere."""
    hot = torch.nn.functional.one_hot(y.long(), n_out) > 0
    return torch.where(hot, 0.99, 0.01).to(torch.float32)


def _sgd_batch(params: dict, x: torch.Tensor, y: torch.Tensor, lr: float) -> dict:
    """One SGD step on the mean squared error: `p - lr * g` for every
    weight, the gradient from `torch.autograd`; no optimiser object."""
    keys = _weight_keys(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
    pred = forward(leaves, x)
    loss = torch.mean((pred - _targets(y, pred.shape[-1])) ** 2)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return {k: (leaves[k] - lr * g).detach() for k, g in zip(keys, grads)}


def train(cfg: MLPConfig, x_uint8: np.ndarray, y: np.ndarray,
          batch_size: int = 10, *, device=None) -> dict:
    """Standard backprop training (paper §II.A) on `device`, from
    `init_params(cfg)`. Returns the trained params as numpy arrays."""
    dev = resolve_device(device)
    params = init_params(cfg, dev)
    x = scale_inputs(torch.as_tensor(np.asarray(x_uint8)).to(dev))
    y = torch.as_tensor(np.asarray(y)).to(dev)
    n = x.shape[0]
    rng = np.random.default_rng(cfg.seed)
    # every epoch's permutation, drawn in the reference's order, moved to
    # the device at once
    orders = torch.as_tensor(
        np.stack([rng.permutation(n) for _ in range(cfg.epochs)])
        if cfg.epochs else np.zeros((0, n), np.int64)).to(dev)
    with full_fp32():
        for order in orders:
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i : i + batch_size]
                params = _sgd_batch(params, x[idx], y[idx], cfg.lr)
    return {k: v.cpu().numpy() for k, v in params.items()}


def accuracy(predict_fn, x_uint8: np.ndarray, y: np.ndarray) -> float:
    """Paper's accuracy metric: fraction of argmax predictions correct."""
    preds = torch.as_tensor(predict_fn(x_uint8)).cpu().numpy()
    return float(np.mean(preds == np.asarray(y)))


def predict_l0(params: dict, device=None):
    """Baseline predictor (L0): float sigmoid net on scaled inputs.
    Returns fn(uint8 images, numpy or tensor) -> int32 class ids on
    `device`."""
    dev = resolve_device(device)
    frozen = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
              for k, v in params.items()}

    def f(x_uint8):
        x = torch.as_tensor(x_uint8).to(dev)
        with full_fp32():
            out = forward(frozen, scale_inputs(x))
        return torch.argmax(out, dim=-1).to(torch.int32)

    return f
