"""Data parallelism of the port's training step.

Under a mesh whose data axes ("pod", "data") span n ranks, each rank
takes its B / n rows of the global batch (`local_rows`; every rank of a
model group the same rows), computes the loss of the global batch and
its own share of the gradient, and the shares are summed over the data
group: by `reduce_grads` after the accumulation for a leaf held whole
over "data", and in the backward for a leaf held as a
shard of its fsdp dim (`parallel/fsdp.py`, whose gradient is
reduce-scattered; `reduce_grads` then sums it over "pod" alone).
Parameters and optimizer state are whole over "data" where an fsdp dim
does not divide the axis, and this rank's shards elsewhere, in every
family (the MoE family's router and experts too, ROADMAP.md A.7d);
either way each rank applies the update to what it holds, and the step
equals the single-process step up to the order of fp32 sums.

The loss of the global batch needs sums over every rank's rows wherever
the loss divides or multiplies by them: `loss_fn`'s nll sum and token
count (the vlm `loss_mask` gives ranks unequal counts), and the MoE
router's statistics (the probability sums and assignment counts of the
load-balance loss, and the z-loss). `global_sum(x)` is such a sum inside
a `reducing(group)` block: its value is the sum of x over the group, and
its backward hands the gradient to the local x unchanged, so each rank
back-propagates its own rows' share. Outside a block it returns x. The
MoE dispatch also needs each expert's queue across ranks: the global
batch's tokens are in rank order (`local_rows`), so this rank's pairs
for an expert follow those of the ranks before it (`exclusive_sum`), and
the capacity is the global batch's.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

__all__ = ["reducing", "group", "snapshot", "size", "sum_over", "global_sum", "exclusive_sum", "local_rows",
           "reduce_grads"]

_ctx = threading.local()


@contextlib.contextmanager
def reducing(group):
    """Make `global_sum` sum over `group` within (None: no reduction)."""
    prev = getattr(_ctx, "group", None)
    _ctx.group = group
    try:
        yield
    finally:
        _ctx.group = prev


def group():
    """The active reduction group (None outside `reducing`)."""
    return getattr(_ctx, "group", None)


def snapshot():
    """A `reducing` block over this thread's current group (for code that
    runs later on another thread: a recomputed layer)."""
    return reducing(group())


def size() -> int:
    """Ranks of the active reduction group (1 outside `reducing`)."""
    g = group()
    return 1 if g is None else dist.get_world_size(g)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`; its backward hands the gradient to the
    local x unchanged (this rank's share)."""
    return _GlobalSum.apply(x, group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    g = group()
    return x if g is None else sum_over(x, g)


def exclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks before this one in the active group
    (zeros outside `reducing`); no gradient."""
    g = group()
    if g is None:
        return torch.zeros_like(x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.detach().contiguous(), group=g)
    return sum(parts[:dist.get_rank(g)], torch.zeros_like(x))


def local_rows(batch: dict, accum: int, n: int, rank: int) -> dict:
    """Rank `rank` of n's rows of a global batch, chosen so that its i-th
    microbatch of B / (accum n) rows is its share of the global batch's
    i-th microbatch."""
    B = next(iter(batch.values())).shape[0]
    if B % (accum * n):
        raise ValueError(f"batch {B} is not a multiple of accum {accum} x {n} data ranks")
    m = B // (accum * n)
    return {k: v.reshape((accum, n, m) + tuple(v.shape[1:]))[:, rank].reshape(
        (accum * m,) + tuple(v.shape[1:])) for k, v in batch.items()}


def reduce_grads(grads: list, group) -> None:
    """Sum each (contiguous) gradient over `group`, in place."""
    for g in grads:
        dist.all_reduce(g, group=group)
