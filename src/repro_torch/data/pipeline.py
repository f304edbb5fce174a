"""Deterministic synthetic data pipeline.

The port's own copy of `repro/data/pipeline.py` (numpy only; the port
imports nothing of the JAX package): the batch for step N is a pure
function of (seed, step, shape), so a restarted run replays the exact
stream (`batch_iterator` starts at any step). The token stream is a
learnable bigram chain: token t+1 is a fixed affine map of token t,
replaced by a uniform draw 10 % of the time.
Batches are numpy arrays; the caller moves them to its device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.base import ArchConfig, ShapeConfig

__all__ = ["make_batch", "batch_iterator"]


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(cfg: ArchConfig, shape: ShapeConfig, step: int, *,
               seed: int = 1234, batch_override: int | None = None) -> dict:
    """Training batch for `step`: dict of numpy arrays."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    rng = _rng(seed, step)
    V = cfg.vocab

    # learnable bigram chain: x_{t+1} = (a * x_t + b) % V with eps-noise
    a = 31337 % V or 7
    x0 = rng.integers(0, V, size=(B, 1))
    noise = rng.random((B, S)) < 0.1
    rand_tok = rng.integers(0, V, size=(B, S))
    toks = np.empty((B, S + 1), np.int32)
    toks[:, 0] = x0[:, 0]
    for t in range(S):
        nxt = (toks[:, t] * a + 17) % V
        toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)

    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.modality == "vlm":
        n_img = max(S // 4, 1)
        pe = rng.normal(0, 1, size=(B, S, cfg.d_model)).astype(np.float32)
        mask = np.zeros((B, S), bool)
        mask[:, :n_img] = True                       # image prefix
        batch["pixel_embeds"] = pe
        batch["pixel_mask"] = mask
        base = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
        batch["positions"] = np.stack([base] * 3, axis=1).copy()   # (B, 3, S)
        lm = np.ones((B, S), np.float32)
        lm[:, :n_img] = 0.0                          # loss only on text
        batch["loss_mask"] = lm
    elif cfg.modality == "audio":
        batch["frame_embeds"] = rng.normal(
            0, 0.02, size=(B, S, cfg.d_model)).astype(np.float32)
    return batch



def batch_iterator(cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 1234,
                   start_step: int = 0):
    """Infinite deterministic stream of (step, batch), resumable at any step."""
    step = start_step
    while True:
        yield step, make_batch(cfg, shape, step, seed=seed)
        step += 1
