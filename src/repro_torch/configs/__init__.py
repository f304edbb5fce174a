"""Architecture config registry of the port.

`get_config(name)` returns the full published config; `smoke(name)` a
reduced same-family variant for CPU tests, with exactly the reductions
of `repro/configs/__init__.py`; `all_cells()` every supported
(architecture x input shape) pair. Every config of the reference is
registered: every LM family (dense, moe, ssm, hybrid) and the vlm and
audio modalities (qwen2-vl-2b, musicgen-medium).
`mnist_fpga`, the paper's own net (family "mlp"), is imported but left
out of `ARCHS`, as in the reference, so `get_config("mnist-fpga")`
raises in both packages; `repro_torch.core` runs it.

`PORT_ONLY` holds the configs the reference has no counterpart of
(zamba2-7b-instruct, Zamba2's published hybrid layout): `get_config`,
`smoke` and the serving launcher take them by name, and they stay out of
`ARCHS` and so out of the dry-run grid and the tests that hold the
registry to the reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (  # noqa: F401
    gemma_2b, granite_moe_1b_a400m, llama3_2_3b, mamba2_2_7b, mnist_fpga, musicgen_medium,
    qwen1_5_4b, qwen2_72b, qwen2_vl_2b, qwen3_moe_30b_a3b, zamba2_2_7b, zamba2_7b_instruct,
)
from repro_torch.models.base import SHAPES, ArchConfig, ShapeConfig, supports_shape

__all__ = ["ARCHS", "PORT_ONLY", "get_config", "smoke", "all_cells"]

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen1_5_4b, qwen2_72b, gemma_2b, llama3_2_3b, qwen2_vl_2b,
              granite_moe_1b_a400m, qwen3_moe_30b_a3b, mamba2_2_7b, zamba2_2_7b,
              musicgen_medium)
}

PORT_ONLY: dict[str, ArchConfig] = {zamba2_7b_instruct.CONFIG.name: zamba2_7b_instruct.CONFIG}


def get_config(name: str) -> ArchConfig:
    if name in PORT_ONLY:
        return PORT_ONLY[name]
    if name not in ARCHS:
        raise KeyError(f"{name!r} is not a registered config (registered: "
                       f"{sorted(ARCHS) + sorted(PORT_ONLY)}); "
                       "mnist-fpga, the paper's net, runs through repro_torch.core")
    return ARCHS[name]


def smoke(name: str) -> ArchConfig:
    """Reduced config preserving the family's structure."""
    c = get_config(name)
    kv = max(1, (4 * c.n_kv_heads) // max(c.n_heads, 1)) if c.n_heads else 0
    repl: dict = dict(
        name=c.name + "-smoke",
        n_layers=4 if c.family == "hybrid" else 2,
        d_model=64,
        n_heads=4 if c.n_heads else 0,
        n_kv_heads=kv,
        head_dim=16 if c.n_heads else 0,
        d_ff=96 if c.d_ff else 0,
        vocab=512,
    )
    if c.family == "moe":
        repl.update(n_experts=8, experts_per_token=2)
    if c.family in ("ssm", "hybrid"):
        repl.update(ssm_state=16, ssm_headdim=16, ssm_groups=1)
    if c.family == "hybrid" and c.hybrid_layer_ids:
        # Zamba2's layout: 2 groups, 3 sites at uneven gaps, heads of 32
        # (heads x head_dim = 2 d_model, as published), adapters of rank 4
        repl.update(n_layers=6, ssm_groups=2, hybrid_layer_ids=(1, 3, 4), head_dim=32,
                    adapter_rank=4)
    elif c.family == "hybrid":
        repl.update(attn_every=2)
    if c.pos == "mrope":
        repl.update(mrope_sections=(2, 3, 3))
    return dataclasses.replace(c, **repl)


def all_cells() -> list[tuple[ArchConfig, ShapeConfig]]:
    """Every supported (architecture x input-shape) pair (the dry-run grid)."""
    return [(cfg, shp) for cfg in ARCHS.values() for shp in SHAPES.values()
            if supports_shape(cfg, shp)]
