"""End-to-end harness for the paper's optimization ladder (§III), on the card.

Counterpart of `repro/core/ladder.py`. Trains the 784-500-10 net with
the paper's protocol (1000 images), then evaluates every ladder stage on
held-out data and checks the paper's structural claims:

  * accuracy decreases monotonically-ish and modestly L0 -> L3
    (paper: 98 / 95 / 94 / 92),
  * L4 (pruning) and L5 (mult-free/specialized) are EXACT rewrites of L3
    (identical predictions),
  * pruning removes a large fraction of weight terms (paper: ~50%).

Training, the ladder predictors and every backend's specialized
predictor run on `device` (the card unless the caller passes "cpu").
The backends are the port's target names; their accuracy keys mirror
the reference's: `torch` -> L4_pruned (JAX `jnp`), `cuda` -> L5_multfree
(JAX `pallas`), `fused` -> L5_fused; any other target string keys as
itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import dataset, mlp, netgen, quantize

__all__ = ["LadderResult", "run_ladder"]

_STAGE_KEYS = {"torch": "L4_pruned", "cuda": "L5_multfree", "fused": "L5_fused"}


@dataclasses.dataclass
class LadderResult:
    acc: dict            # stage name -> accuracy
    stats: netgen.NetgenStats
    prune_info: netgen.PruneInfo
    exact_l4_l5: bool    # L4/L5 predictions identical to L3

    def table(self) -> str:
        rows = ["stage,accuracy,paper_accuracy"]
        paper = {"L0_baseline": 0.98, "L1_step_act": 0.95,
                 "L2_binary_input": 0.94, "L3_int_weights": 0.92,
                 "L4_pruned": 0.92, "L5_multfree": 0.92}
        for k, v in self.acc.items():
            rows.append(f"{k},{v:.4f},{paper.get(k, float('nan')):.2f}")
        return "\n".join(rows)


def run_ladder(
    n_train: int = 1000,
    n_test: int = 1000,
    epochs: int = 60,
    seed: int = 0,
    backends: tuple = ("torch",),
    n_hidden: int | tuple = 500,
    *,
    device=None,
) -> LadderResult:
    """Train, quantize, and check every ladder stage on `device`.
    `n_hidden` may be a tuple of layer sizes; "fused" is 2-layer only.
    `exact_l4_l5` holds when every backend's predictions equal
    `predict_l3`'s bit for bit."""
    from repro_torch import netgen as ng

    dev = resolve_device(device)
    xtr, ytr, xte, yte = dataset.train_test_split(n_train, n_test, seed=seed)
    cfg = mlp.MLPConfig(epochs=epochs, seed=seed + 1, n_hidden=n_hidden)
    params = mlp.train(cfg, xtr, ytr, device=dev)

    acc = {}
    acc["L0_baseline"] = mlp.accuracy(mlp.predict_l0(params, dev), xte, yte)
    acc["L1_step_act"] = mlp.accuracy(quantize.predict_l1(params, dev), xte, yte)
    acc["L2_binary_input"] = mlp.accuracy(quantize.predict_l2(params, dev), xte, yte)
    l3_fn = quantize.predict_l3(params, dev)
    acc["L3_int_weights"] = mlp.accuracy(l3_fn, xte, yte)

    qnet = quantize.quantize(params)
    _, pinfo = netgen.prune(qnet)
    st = netgen.stats(qnet)

    l3_preds = l3_fn(xte)
    exact = True
    with ng.Session(device=dev, capacity=max(1, len(backends))) as session:
        for backend in backends:
            preds = session.compile(qnet, target=backend).artifact(xte)
            acc[_STAGE_KEYS.get(backend, backend)] = float(
                np.mean(preds.cpu().numpy() == yte))
            exact = exact and bool(torch.equal(preds, l3_preds))

    return LadderResult(acc=acc, stats=st, prune_info=pinfo, exact_l4_l5=exact)
