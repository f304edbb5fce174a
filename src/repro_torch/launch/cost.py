"""Counting mode: what one step costs a rank, read from the ops it runs.

The port's counterpart of what the reference's dry run reads from XLA
(`repro/launch/dryrun.py` `_extract`: `cost_analysis()`,
`memory_analysis()` and the collectives of the compiled HLO). A
`Counter` is a `TorchDispatchMode`: entered around one step, it sees
every aten op the step runs, on `meta` tensors (a step of qwen2-72b on a
256-rank world costs no memory) as on CPU or CUDA tensors (a real step
on the card), and records four things:

* `flops`: the matmul family, by `torch.utils.flop_counter`'s registry
  (what `FlopCounterMode` counts: mm, addmm, bmm, baddbmm, convolutions,
  attention). XLA's count also has the elementwise FLOPs; this one has
  none of them.
* `bytes`: each aten op's input and output bytes, view ops and
  allocations without a write (`empty`) excepted. It is an unfused upper
  bound: XLA's "bytes accessed" is taken after fusion, where an
  intermediate of a fused chain is never written.
* `collective_ops`: each c10d collective as (kind, output bytes), the
  kinds of `roofline.KINDS`; `roofline.collective_stats` totals them.
* `peak_bytes`: the argument bytes (storages an op read before any op
  of the step wrote them) plus the high-water mark of the storages the
  step allocated, each alive until its last reference goes (a weak
  reference on the storage: autograd's saved tensors keep theirs). It
  stands in for XLA's argument + output - alias + temp.

A hand-written kernel is no aten op: its wrapper reports its work from
its shapes (`kernel(name, flops=, bytes_=)`), the same whether the CUDA
kernel ran, its plain version ran (CPU) or its fake ran (`meta`); the
aten ops of the plain version inside that block are not counted again.
Counters nest: each active counter records every op and kernel.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["Counter", "kernel", "active", "COLLECTIVES"]

# c10d's collectives (each writes its first argument) -> the reference's HLO kinds
COLLECTIVES = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::recv_": "collective-permute",
}

# allocations that write nothing
_NO_TRAFFIC = {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
               "aten::new_empty_strided", "aten::lift_fresh"}

_active: list = []            # entered counters, innermost last
_lock = threading.RLock()        # a finalizer may run on the thread that holds it


def active() -> list:
    """The counters entered now, innermost last."""
    return list(_active)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Enter around one step; read `flops`, `bytes`, `collective_ops`,
    `peak_bytes` (= `arg_bytes` + `peak_live`) and `kernels` ({name:
    {"calls", "flops", "bytes"}}) after."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_ops: list[tuple[str, int]] = []
        self.kernels: dict[str, dict] = {}
        self.arg_bytes = 0
        self.live = 0
        self.peak_live = 0
        self.n_ops = 0
        self._storages: dict[int, int] = {}      # allocated in the step: key -> bytes
        self._args: set[int] = set()
        self._hidden = 0                          # depth of kernel() blocks

    @property
    def peak_bytes(self) -> int:
        return self.arg_bytes + self.peak_live

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)

    # -- storage lifetimes ---------------------------------------------------

    def _freed(self, key: int) -> None:
        with _lock:
            self.live -= self._storages.pop(key, 0)

    def _see_inputs(self, tensors) -> None:
        for t in tensors:
            s = t.untyped_storage()
            key = s._cdata
            if key not in self._storages and key not in self._args:
                self._args.add(key)
                self.arg_bytes += s.nbytes()
                weakref.finalize(s, self._args.discard, key)

    def _see_outputs(self, tensors) -> None:
        for t in tensors:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._storages or key in self._args:
                continue
            with _lock:
                self._storages[key] = s.nbytes()
                self.live += s.nbytes()
                self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(s, self._freed, key)

    # -- the mode ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        self._see_inputs(ins)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._see_outputs(outs)
        if self._hidden:
            return out
        name = func._schema.name
        kind = COLLECTIVES.get(name)
        if kind is not None:
            self.collective_ops.append((kind, sum(_nbytes(t) for t in _tensors(args[0]))))
            return out
        self.n_ops += 1
        flop_fn = flop_registry.get(func._overloadpacket)
        if flop_fn is not None:
            self.flops += float(flop_fn(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        return out

    def summary(self) -> dict:
        from repro_torch.launch.roofline import collective_stats
        colls = collective_stats(self.collective_ops)
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": float(sum(v for k, v in colls.items() if not k.startswith("_"))),
                "breakdown": colls, "peak_bytes": self.peak_bytes,
                "arg_bytes": self.arg_bytes, "peak_live": self.peak_live,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}, "ops": self.n_ops}


@contextlib.contextmanager
def kernel(name: str, *, flops: float, bytes_: float):
    """A hand-written kernel's launch (or its plain version, or its fake):
    record its work in every active counter, and count none of the aten
    ops inside the block (the plain version's)."""
    counters = list(_active)
    for c in counters:
        k = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(bytes_)
        c.flops += float(flops)
        c.bytes += float(bytes_)
        c._hidden += 1
    try:
        yield
    finally:
        for c in counters:
            c._hidden -= 1
