"""Qwen3-30B-A3B [moe] — 128 experts, top-8, GQA kv=4, head_dim=128.
(Qwen3's q/k RMSNorm is omitted, as in the reference.) [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                  # per-expert FFN width
    vocab=151936,
    act="swiglu",
    norm="rmsnorm",
    norm_eps=1e-6,
    rope_theta=1.0e6,
    n_experts=128,
    experts_per_token=8,
    moe_norm_topk=True,
)
