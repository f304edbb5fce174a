"""Logical-axis sharding rules (FSDP x TP x SP x EP x pod-DP).

Counterpart of `repro/parallel/sharding.py`. Parameters and inputs are
declared with *logical* axis names; the active rule set maps those to
physical mesh axes. Outside a `use_mesh` block `spec` gives the empty
spec and `named_sharding` returns None.

Rules (defaults, the reference's):

  batch    -> ("pod", "data")   data parallel (pod axis joins on multi-pod)
  tokens   -> ("pod", "data", "model")   flattened token dim (MoE dispatch)
  seq      -> ("model",)        sequence parallelism between layers
  vocab    -> ("model",)        vocab-sharded embedding / logits
  heads    -> ("model",)        attention-head tensor parallelism
  kv_heads -> ("model",)        (falls back to None when indivisible - GQA)
  ffn      -> ("model",)        MLP tensor parallelism
  fsdp     -> ("data",)         parameter FSDP axis
  experts  -> ("model",)        expert parallelism
  kv_seq   -> ("model",)        decode-time KV-cache sequence sharding

Divisibility guard: a logical axis drops to a prefix of its mesh axes,
or to replicated, when the dimension is not divisible by the product of
their sizes (20 query heads on a 16-way model axis); every drop is
recorded in `fallbacks()`, entry for entry as the reference records it.

`spec` reads only the mesh's `.shape` mapping of axis name to size, so
the same code serves a `launch.mesh.Mesh` over real ranks and a
shape-only stand-in of the 256- and 512-chip production meshes. It
returns the port's `PartitionSpec`, a tuple with the reference's
entries: a single-axis group collapses to the bare name, trailing Nones
are dropped, and each mesh axis is used once per spec.

`named_sharding` turns a spec into `torch.distributed.tensor`
placements, one per mesh axis in the mesh's order: a tensor dimension
mapped to several mesh axes (("pod", "data")) is `Shard(dim)` on each
of them, which splits it in the order JAX's spec does. The reference's
`shard`, its activation annotation, has no counterpart: the port's
layers carry no activation annotations, since on plain tensors they
would compute nothing, so the batch split is explicit where a path
runs under a mesh (`train/step.py`, `layers/moe_shardmap.py`,
`netgen/serve.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

__all__ = ["DEFAULT_RULES", "PartitionSpec", "NamedSharding", "use_mesh", "active_mesh",
           "snapshot", "fallbacks", "spec", "named_sharding"]

DEFAULT_RULES: dict[str | None, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "tokens": ("pod", "data", "model"),   # flattened token dim (MoE dispatch)
    "seq": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "fsdp": ("data",),
    "experts": ("model",),
    "kv_seq": ("model",),
    "state": (),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per leading tensor dimension: None (replicated), a mesh
    axis name, or a tuple of names; trailing Nones are left out."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; `placements` are its `torch.distributed.tensor`
    form on `mesh.device_mesh`, one per mesh axis."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        axes = list(self.mesh.shape)
        out: list = [Replicate()] * len(axes)
        for dim, part in enumerate(self.spec):
            names = (part,) if isinstance(part, str) else tuple(part or ())
            idx = [axes.index(n) for n in names]
            if idx != sorted(idx):
                raise ValueError(f"{self.spec}: axes {names} out of the mesh's order {axes}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


_ctx = threading.local()


def _state():
    if not hasattr(_ctx, "mesh"):
        _ctx.mesh, _ctx.rules, _ctx.fallbacks = None, dict(DEFAULT_RULES), []
    return _ctx


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Activate a mesh + logical rules for `spec` calls within."""
    st = _state()
    prev = (st.mesh, st.rules, st.fallbacks)
    st.mesh = mesh
    st.rules = dict(DEFAULT_RULES)
    if rules:
        st.rules.update(rules)
    st.fallbacks = []
    try:
        yield
    finally:
        st.mesh, st.rules, st.fallbacks = prev


def snapshot():
    """A context manager that sets exactly this thread's current mesh,
    rules and fallback record (for code that runs later on another
    thread: a recomputed layer records into the same list)."""
    st = _state()
    return _restored(st.mesh, st.rules, st.fallbacks)


@contextlib.contextmanager
def _restored(mesh, rules, record):
    st = _state()
    prev = (st.mesh, st.rules, st.fallbacks)
    st.mesh, st.rules, st.fallbacks = mesh, rules, record
    try:
        yield
    finally:
        st.mesh, st.rules, st.fallbacks = prev


def active_mesh():
    return _state().mesh


def fallbacks() -> list:
    """Logical axes that degraded to a prefix or to replicated:
    (logical, dim, axes, kept axes or None)."""
    return list(_state().fallbacks)


def _axes_for(logical: str | None, dim: int, mesh) -> tuple[str, ...] | None:
    st = _state()
    axes = st.rules.get(logical, ())
    axes = tuple(a for a in axes if a in mesh.shape)
    if not axes:
        return None
    total = math.prod(mesh.shape[a] for a in axes)
    if dim % total != 0:
        # try a prefix of the axes (e.g. drop "pod" but keep "data")
        for cut in range(len(axes) - 1, 0, -1):
            sub = axes[:cut]
            if dim % math.prod(mesh.shape[a] for a in sub) == 0:
                st.fallbacks.append((logical, dim, axes, sub))
                return sub
        st.fallbacks.append((logical, dim, axes, None))
        return None
    return axes


def spec(shape: tuple[int, ...], logical: tuple[str | None, ...]) -> PartitionSpec:
    """PartitionSpec for `shape` under the active rules (no mesh: empty)."""
    mesh = _state().mesh
    if mesh is None:
        return PartitionSpec()
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} and logical axes {logical} differ in length")
    parts: list = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        axes = _axes_for(name, dim, mesh) if name else None
        if axes and not (set(axes) & used):
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def named_sharding(shape: tuple[int, ...], logical: tuple[str | None, ...]
                   ) -> NamedSharding | None:
    mesh = _state().mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, spec(shape, logical))

