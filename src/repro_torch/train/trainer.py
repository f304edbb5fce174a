"""Fault-tolerant training loop.

Counterpart of `repro/train/trainer.py`:

  * checkpoint/restart: periodic atomic checkpoints and resume from the
    latest; the data pipeline is a pure function of the step, so replayed
    steps see the same batches, and a run killed and resumed ends where an
    uninterrupted run ends, bit for bit, where every op is deterministic.
  * failure handling: an injected failure (`fail_at_step`) writes an
    emergency checkpoint of the last good state before re-raising; a
    supervisor (or this trainer called again with resume=True) continues
    from there.
  * straggler detection: a per-step wall-time EMA; steps slower than
    `straggler_factor` x the EMA after the first three are recorded.

The initial state is `tree_init` of the abstract state from a
`torch.Generator` on the device seeded with `tc.seed` (m, v and step are
zeros, so the parameters are those of `tree_init(abstract_params)` for
that seed). The state is updated in place (`train.step`). The history
has the reference's keys and two more: `grad_norm` and `step_s` (each
step's wall seconds, ending when its loss has reached the host).

Under an active mesh the step is data parallel (`train/step.py`): every
rank makes the same initial state from the seed and feeds the step the
same global batches; a resumed state is restored whole on every rank
(outside the mesh, so `ckpt.restore` does not shard it). Rank 0 writes the
checkpoints and the others wait for it at a barrier.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data import pipeline
from repro_torch.models.base import ArchConfig, ShapeConfig, tree_init
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.train import step as step_lib

__all__ = ["TrainerConfig", "InjectedFailure", "run"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    seed: int = 0
    data_seed: int = 1234
    log_every: int = 10
    fail_at_step: int = -1          # failure injection (testing)
    straggler_factor: float = 3.0
    remat: str = "none"             # smoke scale doesn't need remat


class InjectedFailure(RuntimeError):
    pass


def run(cfg: ArchConfig, shape: ShapeConfig, oc: adamw.OptConfig, tc: TrainerConfig, *,
        resume: bool = False, device=None):
    """Train on `device` (the card unless the caller names the CPU);
    returns (final_state, history dict)."""
    dev = resolve_device(device)
    meshed = shd.active_mesh() is not None
    mgr = ckpt_lib.CheckpointManager(tc.ckpt_dir, keep=tc.keep)
    abstract = step_lib.abstract_state(cfg)

    def save(step, state, **kw):
        if not meshed or dist.get_rank() == 0:
            mgr.save(step, state, **kw)
        if meshed:
            dist.barrier()

    start_step, state = 0, None
    if resume:
        with shd.use_mesh(None):
            s, restored = mgr.restore_latest(abstract, device=dev)
        if restored is not None:
            start_step, state = int(s), restored
    if state is None:
        state = tree_init(abstract, torch.Generator(device=dev).manual_seed(tc.seed), dev)
        start_step = 0

    train_step = step_lib.make_train_step(cfg, shape, oc, remat=tc.remat)
    history = {"loss": [], "steps": [], "stragglers": [], "failures": [], "grad_norm": [],
               "step_s": []}
    ema = None
    step = start_step
    try:
        for step, batch_np in pipeline.batch_iterator(cfg, shape, seed=tc.data_seed,
                                                      start_step=start_step):
            if step >= tc.total_steps:
                break
            batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
            t0 = time.perf_counter()
            if step == tc.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > tc.straggler_factor * ema and step > start_step + 2:
                history["stragglers"].append((step, dt, ema))
            history["loss"].append(loss)
            history["steps"].append(step)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            history["step_s"].append(dt)
            if (step + 1) % tc.ckpt_every == 0:
                save(step + 1, state, metadata={"loss": loss})
    except InjectedFailure as e:
        # emergency checkpoint of the last good state, then surface the
        # failure to the supervisor (tests re-enter with resume=True)
        history["failures"].append(str(e))
        save(step, state, tag="emergency")
        raise
    return state, history

