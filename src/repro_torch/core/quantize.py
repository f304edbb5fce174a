"""The paper's integer network (§III, L3) in PyTorch.

Counterpart of `repro/core/quantize.py`: the frozen integer net
(`QuantizedNet`), its content digest, the weight cast, and the dense
L3 reference `predict_quantized` that every compiled target must match
bit for bit. Weights stay numpy arrays, as in the reference, so a net
digests to the same sha256 in both packages.

The ladder predictors `predict_l1`..`predict_l3` (paper §III.A-C) share
one arithmetic, `_step_chain`: the strict step (`acc > 0`) between
layers and the argmax (the first maximal index) at the end. L1 and L2
multiply in fp32 with TF32 off (`mlp.full_fp32`); L3 and
`predict_quantized` are integer arithmetic, run as float64 products
(CUDA has no int32 matmul; exact while fan-ins stay below 2**22) whose
accumulators are wrapped to int32 before the step and the argmax, as
the reference's int32 products wrap.

`from_numpy` / `params_from_numpy` carry the JAX package's nets and
float parameters (as numpy arrays) into the port.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import mlp as mlp_lib

__all__ = [
    "INPUT_THRESHOLD", "WEIGHT_BOUND", "QuantizedNet", "binarize_input",
    "from_numpy", "int_cast_weights", "param_weights", "params_from_numpy",
    "predict_l1", "predict_l2", "predict_l3", "predict_quantized", "quantize",
    "step", "weights_digest",
]

INPUT_THRESHOLD = 128  # paper: pixel cutoff value
WEIGHT_BOUND = 9       # paper: -10 < weights < 10


def step(x: torch.Tensor) -> torch.Tensor:
    """Paper's activation: comparator at 0 (strict)."""
    return (x > 0).to(torch.int32)


def binarize_input(x_uint8: torch.Tensor,
                   threshold: int = INPUT_THRESHOLD) -> torch.Tensor:
    """Paper §III.B: raw pixel in [0,255] -> {0,1} at the cutoff."""
    return (x_uint8.to(torch.int32) > threshold).to(torch.int32)


def int_cast_weights(w, bound: int = WEIGHT_BOUND) -> np.ndarray:
    """Paper §III.C: cast weights to integers, scaled into (-10, 10).

    Scale is per-matrix (a single positive scalar), preserving the sign of
    every pre-activation and the argmax of the output layer.
    """
    w = np.asarray(w, dtype=np.float64)
    s = bound / max(np.abs(w).max(), 1e-12)
    return np.round(w * s).astype(np.int32)


def weights_digest(weights, input_threshold: int = INPUT_THRESHOLD) -> str:
    """Stable content digest of a quantized stack (the compile-cache key):
    sha256 over the threshold, depth, shapes and int64 little-endian
    values — the same bytes as the reference, so a net digests equal in
    both packages."""
    h = hashlib.sha256()
    weights = list(weights)
    h.update(f"netgen-v1:thr={int(input_threshold)}:depth={len(weights)}"
             .encode())
    for w in weights:
        w = np.asarray(w)
        if not np.issubdtype(w.dtype, np.integer):
            raise TypeError(
                f"weights_digest hashes *quantized* stacks; got dtype {w.dtype}")
        w = np.ascontiguousarray(w.astype("<i8"))
        h.update(f":{w.shape}:".encode())
        h.update(w.tobytes())
    return h.hexdigest()


def _weight_keys(params: dict) -> list[str]:
    return sorted((k for k in params if re.fullmatch(r"w\d+", k)),
                  key=lambda k: int(k[1:]))


def param_weights(params: dict) -> list:
    """Ordered weight matrices of a params dict: keys "w1".."wN"."""
    keys = _weight_keys(params)
    if not keys:
        raise ValueError(f"no w<i> keys in params: {sorted(params)}")
    return [params[k] for k in keys]


@dataclasses.dataclass(frozen=True, init=False)
class QuantizedNet:
    """Frozen integer network (input to netgen): integer numpy matrices
    (fan_in, fan_out), any depth. `QuantizedNet(w1=, w2=)` builds the
    paper's 2-layer net; `.w1`/`.w2` read it back."""
    weights: tuple
    input_threshold: int

    def __init__(self, w1=None, w2=None, *, weights=None,
                 input_threshold: int = INPUT_THRESHOLD):
        if weights is None:
            if w1 is None or w2 is None:
                raise TypeError("pass w1= and w2=, or weights=[...]")
            weights = (w1, w2)
        elif w1 is not None or w2 is not None:
            raise TypeError("pass either w1/w2 or weights=, not both")
        object.__setattr__(
            self, "weights", tuple(np.asarray(w) for w in weights))
        object.__setattr__(self, "input_threshold", int(input_threshold))

    @property
    def depth(self) -> int:
        return len(self.weights)

    def _pair(self) -> tuple:
        if self.depth != 2:
            raise AttributeError(
                f".w1/.w2 are 2-layer accessors; this net has depth "
                f"{self.depth} — use .weights")
        return self.weights

    @property
    def w1(self) -> np.ndarray:
        return self._pair()[0]

    @property
    def w2(self) -> np.ndarray:
        return self._pair()[1]

    @property
    def shapes(self) -> tuple:
        return tuple(w.shape for w in self.weights)

    def digest(self) -> str:
        """Content digest of this net (see `weights_digest`)."""
        return weights_digest(self.weights, self.input_threshold)


def from_numpy(weights, input_threshold: int = INPUT_THRESHOLD
               ) -> QuantizedNet:
    """A port `QuantizedNet` from integer numpy matrices, e.g. the
    `.weights` and `.input_threshold` of a JAX-package net."""
    return QuantizedNet(weights=[np.asarray(w) for w in weights],
                        input_threshold=input_threshold)


def params_from_numpy(params: dict) -> dict:
    """Float parameters {"w1": array, ...} as float32 CPU tensors."""
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
            for k, v in params.items()}


def quantize(params: dict) -> QuantizedNet:
    """Cast a float stack (any depth) to the frozen integer net."""
    return QuantizedNet(weights=[
        int_cast_weights(torch.as_tensor(w).detach().cpu().numpy())
        for w in param_weights(params)])


def _step_chain(x: torch.Tensor, ws, integer: bool) -> torch.Tensor:
    """Shared ladder arithmetic: strict step between layers, argmax (the
    first maximal index) at the end; int32 class ids. `integer`: x and ws
    are float64 holding integers, and each accumulator is wrapped to
    int32 before the step and the argmax, as int32 products wrap."""
    def acc(a):
        return a.to(torch.int64).to(torch.int32) if integer else a

    for w in ws[:-1]:
        x = step(acc(x @ w)).to(x.dtype)
    return torch.argmax(acc(x @ ws[-1]), dim=-1).to(torch.int32)


def _float_weights(params: dict, dev: torch.device) -> list:
    return [torch.as_tensor(w, dtype=torch.float32).to(dev)
            for w in param_weights(params)]


def predict_l1(params: dict, device=None):
    """L1: step hidden activations, float weights, scaled float input.
    Returns fn(uint8 images, numpy or tensor) -> int32 class ids on
    `device`."""
    dev = resolve_device(device)
    ws = _float_weights(params, dev)

    def f(x_uint8):
        x = mlp_lib.scale_inputs(torch.as_tensor(x_uint8).to(dev))
        with mlp_lib.full_fp32():
            return _step_chain(x, ws, integer=False)

    return f


def predict_l2(params: dict, device=None):
    """L2: + binary inputs (pixel > 128)."""
    dev = resolve_device(device)
    ws = _float_weights(params, dev)

    def f(x_uint8):
        x = binarize_input(torch.as_tensor(x_uint8).to(dev)).to(torch.float32)
        with mlp_lib.full_fp32():
            return _step_chain(x, ws, integer=False)

    return f


def predict_l3(params: dict, device=None):
    """L3: + integer weights. The whole network is now integer arithmetic:
    binary inputs, int weights, int accumulators, sign-bit activations —
    exactly the arithmetic the paper's Verilog implements."""
    return predict_quantized(quantize(params), device=device)


def predict_quantized(net: QuantizedNet, device=None):
    """Reference L3 arithmetic for a quantized net: the dense path the
    compiled targets must match bit for bit. Returns fn(uint8 images
    (B, n_in), numpy or tensor) -> int32 class ids on `device`.

    The layer products run in float64 (CUDA has no integer matmul), which
    is exact while a sum of {0, 1}-selected int32 weights stays below
    2**53, i.e. for fan-ins below 2**22. Each accumulator is then wrapped
    to int32 before the step and before the argmax, as the reference's
    int32 products wrap.
    """
    dev = resolve_device(device)
    ws = [torch.as_tensor(np.asarray(w), dtype=torch.float64, device=dev)
          for w in net.weights]
    thr = net.input_threshold

    def f(x_uint8):
        x = torch.as_tensor(x_uint8, device=dev)
        return _step_chain(binarize_input(x, thr).to(torch.float64), ws, integer=True)

    return f
