"""Granite-3.0-1B-A400M [moe] — 32 experts, top-8, GQA kv=8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                  # per-expert FFN width
    vocab=49155,
    act="swiglu",
    norm="rmsnorm",
    norm_eps=1e-6,
    tie_embeddings=True,
    rope_theta=1.0e4,
    n_experts=32,
    experts_per_token=8,
)
