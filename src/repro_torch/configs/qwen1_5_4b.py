"""Qwen1.5-4B [dense] — QKV bias, full-head GQA (kv == heads).
[hf:Qwen/Qwen1.5-4B; hf-verified family config]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    act="swiglu",
    norm="rmsnorm",
    norm_eps=1e-6,
    qkv_bias=True,
    rope_theta=5.0e6,
)
