"""netgen on PyTorch: the paper's net-to-hardware compiler, served on a GPU.

Counterpart of `repro.netgen`. A `QuantizedNet` is lowered to the
circuit IR (`frontend.lower`), optimized by a `PipelineSpec` (default
`zeros,prune`), lowered to an `ExecutionPlan`, and compiled for a
target:

    torch                dense masked-column-sum oracle (JAX: `jnp`)
    cuda                 per-layer dense kernel chain (JAX: `pallas`)
    cuda[packed=true]    per-layer chain over bit-packed activations
    cuda[planes=true]    per-layer bit-plane kernel chain
    cuda[fusednet=true]  the whole planes-form net in one kernel launch
    fused                the 2-layer paper net in one kernel launch

`Session` holds the compiled artifacts for one device (the card unless
`device="cpu"`), and `NetServer` serves registered versions, stacking
compatible ones into one multi-net dispatch.
"""
from repro_torch.netgen.frontend import lower
from repro_torch.netgen.graph import Circuit, IrregularCircuitError
from repro_torch.netgen.pipeline import PipelineSpec
from repro_torch.netgen.plan import (
    ExecutionPlan, MegakernelView, lower_circuit, stack_plans,
)
from repro_torch.netgen.serve import NetServer
from repro_torch.netgen.session import Artifact, Session
from repro_torch.netgen.targets import list_targets, resolve_target

__all__ = [
    "Artifact", "Circuit", "ExecutionPlan", "IrregularCircuitError",
    "MegakernelView", "NetServer", "PipelineSpec", "Session",
    "list_targets", "lower", "lower_circuit",
    "resolve_target", "stack_plans",
]
