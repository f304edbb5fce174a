"""Fault-tolerant checkpointing: atomic, with the reference's on-disk
layout.

Counterpart of `repro/checkpoint/ckpt.py`. One directory per step:

    <root>/step_<N>/
        meta.json        leaf names, step, time, user metadata
        arrays.npz       one entry per leaf, named by its path

Leaves are named as the reference names them, by `jax.tree_util.keystr`
of the path (`['opt']['m']['embed']['tok']`, `base.keystr`), in its
flatten order, so a checkpoint written by either package restores in
the other. Write protocol: serialize into `<root>/.tmp-step_<N>`, fsync
the metadata, then rename: a partly written checkpoint is never visible
under its final name. `restore` loads onto the device given (the card
unless the caller names the CPU), checking each leaf's shape and
casting it to the abstract tree's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.base import keystr, tree_items, tree_unflatten

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

# numpy's name for each dtype a state holds (numpy has no bfloat16)
_NUMPY = {torch.float32: np.float32, torch.float16: np.float16, torch.float64: np.float64,
          torch.int32: np.int32, torch.int64: np.int64, torch.int8: np.int8,
          torch.uint8: np.uint8, torch.bool: np.bool_}


def save(root: str, step: int, state, *, metadata: dict | None = None) -> str:
    """Atomically persist `state` (a tree of tensors) for `step`."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = os.path.join(root, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    pairs = [(keystr(p), t) for p, t in tree_items(state)]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: t.detach().cpu().numpy() for k, t in pairs})
    meta = {"step": step, "time": time.time(), "keys": [k for k, _ in pairs],
            "metadata": metadata or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore(path: str, abstract_state, *, device=None):
    """Load a checkpoint into the structure of `abstract_state` (a
    ParamInfo tree or a tensor tree), on `device`."""
    device = resolve_device(device)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}

    paths, out = [], []
    for p, leaf in tree_items(abstract_state):
        key = keystr(p)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.asarray(data[key], dtype=_NUMPY[leaf.dtype])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} != {tuple(leaf.shape)}")
        paths.append(p)
        out.append(torch.from_numpy(arr).to(device))
    return tree_unflatten(paths, out)


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root) if d.startswith("step_")]
    return max(steps) if steps else None


class CheckpointManager:
    """keep-last-N manager with emergency-save support."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, state, *, metadata=None, tag: str = "") -> str:
        path = save(self.root, step, state, metadata={**(metadata or {}), "tag": tag})
        self._gc()
        return path

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                       if d.startswith("step_"))
        for s in (steps[: -self.keep] if self.keep > 0 else []):
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"))

    def restore_latest(self, abstract_state, *, device=None):
        s = latest_step(self.root)
        if s is None:
            return None, None
        return s, restore(os.path.join(self.root, f"step_{s:08d}"), abstract_state,
                          device=device)
